"""The reader of a flight-recorder run directory: summarize / export it.

The port's copy of ``dcfm_tpu/obs/cli.py``.  It reads ONLY the JSONL event
files (never a checkpoint payload), so a post-mortem works on a machine
with nothing but the run directory, and it reads a directory either
package wrote (the event schema and file names are shared)::

    python -m dcfm_tpu_torch.obs.cli ck.npz.obs                 # summary
    python -m dcfm_tpu_torch.obs.cli ck.npz.obs --json          # as JSON
    python -m dcfm_tpu_torch.obs.cli ck.npz.obs --tail 20       # last 20
    python -m dcfm_tpu_torch.obs.cli ck.npz.obs --trace t.json  # Chrome

The summary covers: launches and deaths (exit codes + checkpoint
iterations), promoted/demoted/orphaned checkpoint generations, resume
decisions per launch, sentinel rewinds, injected faults, per-phase
walls of the newest completed fit, the stream overlap fraction and the
warm-start decisions, and the serving fleet's workers, swaps and drains.
The port's CLI (``python -m dcfm_tpu_torch.cli events``) calls
:func:`events_main`.
"""

from __future__ import annotations

import argparse
import json
from typing import List

from dcfm_tpu_torch.obs.recorder import event_files, run_events_with_stats
from dcfm_tpu_torch.obs.spans import overlap_fraction, write_chrome_trace


def _fmt_event(e: dict) -> str:
    skip = {"t", "mono", "run", "role", "seq", "event"}
    fields = " ".join(f"{k}={v}" for k, v in e.items() if k not in skip)
    return f"{e.get('t', 0.0):.3f} {e.get('role', '?'):>14} " \
           f"{e.get('event', '?')}" + (f"  {fields}" if fields else "")


def summarize(run_dir: str, events=None, torn: int = 0) -> dict:
    """Machine-readable run summary from the event log alone.  Pass
    ``events``/``torn`` (from ``run_events_with_stats``) to reuse an
    already-parsed stream; without them one parse happens here."""
    if events is None:
        events, torn = run_events_with_stats(run_dir)
    by = {}
    for e in events:
        by.setdefault(e.get("event"), []).append(e)

    launches = [{"attempt": e.get("attempt"),
                 "checkpoint_iteration": e.get("checkpoint_iteration")}
                for e in by.get("supervisor_launch", [])]
    deaths = [{"exit": e.get("exit"), "iteration": e.get("iteration"),
               "launch": e.get("launch")}
              for e in by.get("supervisor_death", [])]
    promotions = [{"iteration": e.get("iteration"), "slot": e.get("slot")}
                  for e in by.get("checkpoint_promote", [])]
    resumes = [{"role": e.get("role"), "decision": e.get("decision"),
                "iteration": e.get("iteration"),
                "acc_start": e.get("acc_start")}
               for e in by.get("resume_decision", [])]
    # elastic adoptions (runtime/resume._try_elastic) and the
    # supervisor's relaunch capacity probes: the topology-change trail
    # beside the resume decisions
    elastics = [{"role": e.get("role"), "decision": e.get("decision"),
                 "from_chains": e.get("from_chains"),
                 "to_chains": e.get("to_chains"),
                 "kept": e.get("kept"), "dropped": e.get("dropped"),
                 "birthed": e.get("birthed"),
                 "fold_draws": e.get("fold_draws"),
                 "iteration": e.get("iteration"),
                 "reason": e.get("reason"),
                 "from_topology": e.get("from_topology"),
                 "to_topology": e.get("to_topology")}
                for e in by.get("elastic_resume", [])]
    capacity_probes = [{"recorded_topology": e.get("recorded_topology"),
                        "current_topology": e.get("current_topology"),
                        "degraded": e.get("degraded"),
                        "posture": e.get("posture")}
                       for e in by.get("elastic_capacity", [])]
    # HOST-elastic trail: the supervisor's capacity-probe degrades
    # (resilience/supervisor, pod_degrade) and the resume's adoption of
    # a foreign-host-count checkpoint set (runtime/resume, pod_elastic)
    pod_degrades = [{"decision": e.get("decision"),
                     "posture": e.get("posture"),
                     "from_processes": e.get("from_processes"),
                     "to_processes": e.get("to_processes")}
                    for e in by.get("pod_degrade", [])]
    pod_adoptions = [{"role": e.get("role"),
                      "from_hosts": e.get("from_hosts"),
                      "to_hosts": e.get("to_hosts"),
                      "pod_adoptions": e.get("pod_adoptions"),
                      "pair_panels": e.get("pair_panels"),
                      "iteration": e.get("iteration")}
                     for e in by.get("pod_elastic", [])]
    faults = [{k: v for k, v in e.items()
               if k in ("op", "when", "event_name", "at_iteration",
                        "iteration", "target", "path", "write", "role")}
              for e in by.get("fault", [])]
    rewinds = [{"iteration": e.get("iteration"),
                "to_iteration": e.get("to_iteration"),
                "acc_start": e.get("acc_start")}
               for e in by.get("sentinel_rewind", [])]
    early_stops = [{"iteration": e.get("iteration"),
                    "total_iters": e.get("total_iters"),
                    "rhat": e.get("rhat"), "ess": e.get("ess"),
                    "rhat_threshold": e.get("rhat_threshold"),
                    "ess_target": e.get("ess_target")}
                   for e in by.get("early_stop", [])]
    # "newest fit" must mean the newest REAL run: supervise()'s no-op
    # materialization resume (role "materialize", zero chunks) records
    # its own fit_done last, and its ~0 phase walls would otherwise
    # shadow the supervised chain's actual timings
    fit_done = [e for e in by.get("fit_done", [])
                if e.get("role") != "materialize"] \
        or by.get("fit_done", [])
    phases = fit_done[-1].get("phases") if fit_done else None
    stream = fit_done[-1].get("stream") if fit_done else None
    chunks = by.get("chunk", [])
    saves = by.get("checkpoint_save", [])
    # serve-fleet events (serve --workers N run dirs)
    worker_launches = [{"worker": e.get("worker"),
                        "launch": e.get("launch"), "pid": e.get("pid")}
                       for e in by.get("worker_launch", [])]
    worker_deaths = [{"worker": e.get("worker"), "exit": e.get("exit"),
                      "launch": e.get("launch"),
                      "uptime_s": e.get("uptime_s")}
                     for e in by.get("worker_death", [])]
    swaps = [{"worker": e.get("worker"),
              "generation": e.get("generation"),
              "from_generation": e.get("from_generation")}
             for e in by.get("serve_swap", [])]
    swap_refusals = [{"worker": e.get("worker"),
                      "reason": e.get("reason")}
                     for e in by.get("serve_swap_refused", [])]
    promotes = [{"target": e.get("target"),
                 "generation": e.get("generation"),
                 "verified": e.get("verified")}
                for e in by.get("artifact_promote", [])]
    # delta-promotion events (serve/delta.py): what each generation
    # actually shipped vs a full artifact, plus recorded fallbacks
    delta_exports = [{"panels_changed": e.get("panels_changed"),
                      "panels_total": e.get("panels_total"),
                      "bytes_shipped": e.get("bytes_shipped"),
                      "full_bytes": e.get("full_bytes")}
                     for e in by.get("delta_export", [])]
    delta_promos = [{"target": e.get("target"),
                     "generation": e.get("generation"),
                     "panels_changed": e.get("panels_changed"),
                     "panels_total": e.get("panels_total"),
                     "bytes_shipped": e.get("bytes_shipped"),
                     "full_bytes": e.get("full_bytes"),
                     "drift": e.get("drift")}
                    for e in by.get("delta_promote", [])]
    delta_fallbacks = [{"reason": e.get("reason"),
                        "kind": e.get("kind"),
                        "generation": e.get("generation")}
                       for e in by.get("delta_fallback", [])]
    # online fit->serve loop events (watch run dirs)
    detections = [{"kind": e.get("kind"), "n": e.get("n"),
                   "p": e.get("p"),
                   "target_generation": e.get("target_generation")}
                  for e in by.get("online_detect", [])]
    online_promos = [{"generation": e.get("generation"),
                      "kind": e.get("kind"), "warm": e.get("warm"),
                      "drift": e.get("drift"),
                      "refit_s": e.get("refit_s"),
                      "cycle_s": e.get("cycle_s")}
                     for e in by.get("online_promote", [])]
    online_refusals = [{"stage": e.get("stage"),
                        "reason": e.get("reason"),
                        "kind": e.get("kind"),
                        "generation": e.get("generation")}
                       for e in by.get("online_refused", [])]
    warm_starts = [{"decision": e.get("decision"),
                    "reason": e.get("reason"),
                    "verbatim_leaves": e.get("verbatim_leaves"),
                    "leaves": e.get("leaves"),
                    "relineage": e.get("relineage")}
                   for e in by.get("warm_start", [])]
    return {
        "run_dir": run_dir,
        "events": len(events),
        "files": len(event_files(run_dir)),
        "torn_lines": torn,
        "runs": sorted({e.get("run") for e in events if e.get("run")}),
        "launches": launches,
        "deaths": deaths,
        "checkpoint_promotions": promotions,
        "checkpoint_demotions": len(by.get("checkpoint_demote", [])),
        "checkpoint_orphans": len(by.get("checkpoint_orphan", [])),
        "checkpoint_saves": len(saves),
        "last_checkpoint_iteration": (saves[-1].get("iteration")
                                      if saves else None),
        "resume_decisions": resumes,
        "elastic_resumes": elastics,
        "elastic_capacity_probes": capacity_probes,
        "pod_degrades": pod_degrades,
        "pod_adoptions": pod_adoptions,
        "sentinel_rewinds": rewinds,
        "early_stops": early_stops,
        "faults_injected": faults,
        "chunks": len(chunks),
        "chain_s": round(sum(float(e.get("dur_s", 0.0))
                             for e in chunks), 3),
        "phases": phases,
        "stream": stream,
        "overlap_fraction": overlap_fraction(events),
        "worker_launches": worker_launches,
        "worker_deaths": worker_deaths,
        "serve_swaps": swaps,
        "serve_swap_refusals": swap_refusals,
        "serve_sheds": len([e for e in by.get("serve_shed", [])
                            if e.get("active")]),
        "serve_client_aborts": len(by.get("serve_client_abort", [])),
        "artifact_promotions": promotes,
        "delta_exports": delta_exports,
        "delta_promotions": delta_promos,
        "delta_fallbacks": delta_fallbacks,
        "fleet_poisoned": bool(by.get("fleet_poisoned")),
        "fleet_watchdog_fired": bool(by.get("fleet_watchdog_fired")),
        "fleet_drained": bool(by.get("fleet_drained")),
        "online_detections": detections,
        "online_refits": len(by.get("online_refit", [])),
        "online_promotions": online_promos,
        "online_refusals": online_refusals,
        "warm_starts": warm_starts,
        "watch_cycles": (by["watch_stop"][-1].get("cycles")
                         if by.get("watch_stop") else None),
    }


def _print_summary(s: dict, out: List[str]) -> None:
    out.append(f"flight recorder: {s['run_dir']}  "
               f"({s['files']} file(s), {s['events']} events"
               + (f", {s['torn_lines']} torn line(s) tolerated"
                  if s["torn_lines"] else "") + ")")
    if s["launches"]:
        out.append(f"launches: {len(s['launches'])}")
        for l in s["launches"]:
            out.append(f"  launch #{l['attempt']} from checkpoint "
                       f"iteration {l['checkpoint_iteration']}")
    if s["deaths"]:
        out.append(f"deaths: {len(s['deaths'])}")
        for d in s["deaths"]:
            out.append(f"  death (exit {d['exit']}) at checkpoint "
                       f"iteration {d['iteration']} "
                       f"(launch {d['launch']})")
    if s["checkpoint_promotions"]:
        for p in s["checkpoint_promotions"]:
            out.append(f"promoted generation: iteration "
                       f"{p['iteration']} -> {p['slot']}")
    if s["checkpoint_demotions"]:
        out.append(f"demoted corrupt generations: "
                   f"{s['checkpoint_demotions']}")
    if s["checkpoint_orphans"]:
        out.append(f"orphaned slots: {s['checkpoint_orphans']}")
    for r in s["resume_decisions"]:
        out.append(f"resume decision [{r['role']}]: {r['decision']} at "
                   f"iteration {r['iteration']} "
                   f"(acc_start {r['acc_start']})")
    for e in s.get("elastic_resumes", ()):
        ft, tt = e.get("from_topology") or {}, e.get("to_topology") or {}
        topo = (f" [{ft.get('num_chains')}x{ft.get('num_devices')}"
                f" -> {tt.get('num_chains')}x{tt.get('num_devices')}]"
                if ft or tt else "")
        if e["decision"] == "elastic":
            out.append(
                f"elastic resume [{e['role']}]: {e['from_chains']} -> "
                f"{e['to_chains']} chains at iteration "
                f"{e['iteration']} (kept {e['kept']}, dropped "
                f"{e['dropped']}, birthed {e['birthed']}, folded "
                f"{e['fold_draws']} draws into the pool){topo}")
        else:
            out.append(f"elastic resume [{e['role']}]: refused "
                       f"({e.get('reason')}){topo}")
    for c in s.get("elastic_capacity_probes", ()):
        if c.get("degraded"):
            out.append(
                "capacity probe: topology changed "
                f"{c['recorded_topology']} -> {c['current_topology']} "
                f"(posture: {c['posture']})")
    for d in s.get("pod_degrades", ()):
        if d["decision"] == "degraded":
            out.append(f"pod degraded {d['from_processes']} -> "
                       f"{d['to_processes']} host(s): relaunching on the "
                       "survivors")
        else:
            out.append(f"pod degrade REFUSED at {d['from_processes']} -> "
                       f"{d['to_processes']} host(s) "
                       f"(posture: {d['posture']})")
    for a in s.get("pod_adoptions", ()):
        panels = (f", re-partitioned {a['pair_panels']} pair panels"
                  if (a.get("pair_panels") or 0) > 0 else "")
        out.append(f"pod adopted [{a['role']}]: {a['from_hosts']} -> "
                   f"{a['to_hosts']} host(s) at iteration "
                   f"{a['iteration']}{panels} "
                   f"(adoption #{a['pod_adoptions']})")
    for r in s["sentinel_rewinds"]:
        out.append(f"sentinel rewind: iteration {r['iteration']} -> "
                   f"{r['to_iteration']}")
    for e in s["early_stops"]:
        out.append(f"early stop: converged at iteration "
                   f"{e['iteration']}/{e['total_iters']} "
                   f"(R-hat {e['rhat']} < {e['rhat_threshold']}, "
                   f"ESS {e['ess']} >= {e['ess_target']:g})")
    for f in s["faults_injected"]:
        out.append("fault injected: " + " ".join(
            f"{k}={v}" for k, v in f.items()))
    out.append(f"chunks: {s['chunks']}  chain wall: {s['chain_s']}s  "
               f"checkpoint saves: {s['checkpoint_saves']}"
               + (f" (last at iteration "
                  f"{s['last_checkpoint_iteration']})"
                  if s["last_checkpoint_iteration"] is not None else ""))
    if s["phases"]:
        out.append("phases (newest fit): " + "  ".join(
            f"{k}={v}" for k, v in s["phases"].items()))
    if s["stream"]:
        st = s["stream"]
        out.append(f"stream: snapshots={st.get('snapshots')} "
                   f"skipped={st.get('skipped')} "
                   f"exposed_fetch_s={st.get('exposed_fetch_s')}")
    if s["overlap_fraction"] is not None:
        out.append(f"overlap fraction (drain hidden behind compute): "
                   f"{s['overlap_fraction']:.3f}")
    if s["worker_launches"]:
        out.append(f"serve workers launched: {len(s['worker_launches'])}")
    if s["worker_deaths"]:
        out.append(f"serve worker deaths: {len(s['worker_deaths'])}")
        for d in s["worker_deaths"]:
            out.append(f"  worker {d['worker']} died (exit {d['exit']}, "
                       f"launch {d['launch']})")
    if s["artifact_promotions"]:
        for pr in s["artifact_promotions"]:
            out.append(f"artifact promoted: {pr['target']} -> "
                       f"generation {pr['generation']} "
                       f"(verified={pr['verified']})")
    if s["delta_promotions"]:
        out.append(f"delta promotions: {len(s['delta_promotions'])}")
        for dp in s["delta_promotions"]:
            out.append(f"  delta promoted: {dp['target']} -> generation "
                       f"{dp['generation']} "
                       f"({dp['panels_changed']}/{dp['panels_total']} "
                       f"panels shipped, {dp['bytes_shipped']} of "
                       f"{dp['full_bytes']} full bytes, "
                       f"drift {dp['drift']})")
    for df in s["delta_fallbacks"]:
        out.append(f"delta FELL BACK to full promotion (generation "
                   f"{df['generation']}, {df['kind']}): {df['reason']}")
    if s["serve_swaps"]:
        out.append(f"hot-swaps: {len(s['serve_swaps'])}")
        for sw in s["serve_swaps"]:
            out.append(f"  worker {sw['worker']}: generation "
                       f"{sw['from_generation']} -> {sw['generation']}")
    if s["serve_swap_refusals"]:
        out.append(f"hot-swaps REFUSED (old artifact kept serving): "
                   f"{len(s['serve_swap_refusals'])}")
        for sw in s["serve_swap_refusals"]:
            out.append(f"  worker {sw['worker']}: {sw['reason']}")
    if s["serve_sheds"]:
        out.append(f"load-shed episodes: {s['serve_sheds']}")
    if s["serve_client_aborts"]:
        out.append(f"client aborts/timeouts shed: "
                   f"{s['serve_client_aborts']}")
    if s["online_detections"]:
        out.append(f"online detections: {len(s['online_detections'])}  "
                   f"refits: {s['online_refits']}  "
                   f"promotions: {len(s['online_promotions'])}  "
                   f"refusals: {len(s['online_refusals'])}")
        for d in s["online_detections"]:
            out.append(f"  detected {d['kind']}: n={d['n']} p={d['p']} "
                       f"-> generation {d['target_generation']}")
    for w in s["warm_starts"]:
        if w["decision"] == "warm":
            out.append(f"warm start: {w['verbatim_leaves']}/{w['leaves']} "
                       f"leaves verbatim (relineage "
                       f"{w['relineage']})")
        else:
            out.append(f"warm start fell back COLD: {w['reason']}")
    for p in s["online_promotions"]:
        out.append(f"online promotion: generation {p['generation']} "
                   f"({p['kind']}, {'warm' if p['warm'] else 'cold'}, "
                   f"drift {p['drift']}, refit {p['refit_s']}s, "
                   f"data-to-serving {p['cycle_s']}s)")
    for r in s["online_refusals"]:
        out.append(f"online cycle REFUSED at {r['stage']} (old artifact "
                   f"kept serving): {r['reason']}")
    if s["watch_cycles"] is not None:
        out.append(f"watch daemon promoted {s['watch_cycles']} "
                   f"cycle(s) before stopping")
    if s["fleet_poisoned"]:
        out.append("FLEET POISONED: repeated instant worker deaths")
    if s["fleet_watchdog_fired"]:
        out.append("FLEET WATCHDOG FIRED: supervision exceeded bound")
    if s["fleet_drained"]:
        out.append("fleet drained cleanly")


def events_main(argv=None) -> int:
    try:
        return _events_main(argv)
    except BrokenPipeError:
        # `... | head` closing the pipe is not an error
        return 0


def _events_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dcfm_tpu_torch.obs.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir",
                   help="flight-recorder run directory (FitResult."
                        "events_path; <checkpoint>.obs for supervised "
                        "runs)")
    p.add_argument("--json", action="store_true",
                   help="print the summary as one JSON object")
    p.add_argument("--tail", type=int, default=0, metavar="N",
                   help="print the last N raw events instead of the "
                        "summary")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="also write a Chrome trace-event file (open in "
                        "Perfetto / chrome://tracing)")
    args = p.parse_args(argv)
    if not event_files(args.run_dir):
        print(f"no events-*.jsonl files under {args.run_dir}")
        return 2
    # ONE parse of the log feeds every output mode
    events, torn = run_events_with_stats(args.run_dir)
    if args.trace:
        write_chrome_trace(events, args.trace)
        print(f"chrome trace: {args.trace} ({len(events)} events)")
    if args.tail:
        for e in events[-args.tail:]:
            print(_fmt_event(e))
        return 0
    s = summarize(args.run_dir, events=events, torn=torn)
    if args.json:
        print(json.dumps(s))
        return 0
    lines: List[str] = []
    _print_summary(s, lines)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(events_main())
