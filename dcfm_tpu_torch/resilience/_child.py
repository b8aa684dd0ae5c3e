"""Child-process fit runner for :func:`dcfm_tpu_torch.resilience.supervise`.

``python -m dcfm_tpu_torch.resilience._child cfg.json Y.npy`` reads the
FitConfig the parent wrote, loads the data matrix, and runs ``fit`` with
resume-if-anything-exists semantics: strict once a checkpoint is
discoverable (the live file or a retained ``.bakK`` generation - the
port's one-process discovery; a ``.procK-of-N`` set is discoverable too,
so the resume refuses it by name), identical to the CLI's ``--resume``
rule, so an incompatible checkpoint is a hard refusal, never a silent
restart over the old run's progress.  The fit runs on the device the
config's ``backend`` names (the card unless "torch_cpu").  Exit code 0
means the chain COMPLETED and its final full checkpoint is durable; any
other exit (including death by signal) is the supervisor's cue to
verify, back off, and relaunch.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(  # dcfm: ignore[DCFM901] - __main__-style usage line of the child runner
            "usage: python -m dcfm_tpu_torch.resilience._child cfg.json "
            "Y.npy", file=sys.stderr)
        return 2
    cfg_path, data_path = argv
    from dcfm_tpu_torch.utils.checkpoint import (
        checkpoint_discoverable, config_from_checkpoint_meta)

    with open(cfg_path, "r", encoding="utf-8") as f:
        cfg = config_from_checkpoint_meta({"config": json.load(f)})
    cfg = dataclasses.replace(
        cfg, resume=checkpoint_discoverable(cfg.checkpoint_path))

    from dcfm_tpu_torch.api import fit
    fit(np.load(data_path), cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
