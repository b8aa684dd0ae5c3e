"""Each configuration brings its own plain reference: ``check.reference``
calls the file the configuration names, the built-in reference takes its
prior as a record, and ``fit_config`` builds every sub-config of the
program's ``ModelConfig`` from the file.  On the CPU, at conftest's tiny
sizes."""

import dataclasses
import hashlib
import os
import time

import pytest
import torch

from conftest import ROOT, tiny_cell
from fitbench import cell as runner, check, data, spec
from fitref import gibbs

CELLS = ["ns_mgp.fit", "c5_hs_adapt.fit"]

# SHA-256 of the reference's panels for tiny_cell(name) on data seed 1 and
# run seed 3, on the CPU: pinned, so that a change to the reference's
# operations, their order, its draws or its dtypes shows here
DIGESTS = {
    ("ns_mgp.fit", torch.float64):
        "b0ba58c21d0cb91f6ec366723dbd32cbf2b6996a6c34f7553577729591baa197",
    ("ns_mgp.fit", torch.float32):
        "a24a2ca6f1fc51a3f7c05e3d398c89bf07fd087fef01f275ca0ec6a5e6e032bd",
    ("c5_hs_adapt.fit", torch.float64):
        "9f968477ab036d7fef52f96e967885eedf41da89cbd23f861c1c92fd955d81e4",
    ("c5_hs_adapt.fit", torch.float32):
        "c0c743d0244d68cbae36c6bb695f33c2cfa2c9b64868287fc015b2f2caac6eed",
}


def _reference_file(tmp_path, body: str) -> str:
    """``body`` written as a reference file; its path relative to the
    checkout's root, as a configuration names it."""
    path = tmp_path / "ref.py"
    path.write_text(body)
    return os.path.relpath(path, ROOT)


def test_the_named_file_is_the_one_called(tmp_path):
    c = tiny_cell("ns_mgp.fit")
    path = _reference_file(tmp_path, (
        "import torch\n"
        "def posterior_mean(Y, model, schedule, seed, chains, device, *,\n"
        "                   dtype):\n"
        "    panels = torch.arange(40, dtype=dtype).reshape(10, 2, 2)\n"
        "    return panels + seed, (Y.shape, model['prior'], chains,\n"
        "                           schedule['thin'], str(device))\n"))
    config = dict(c.config, reference=path)
    Y = data.make_data(c.config["data"], 1, "cpu")
    panels, prep = check.reference(Y, config, c.traffic, 3, "cpu",
                                   dtype=torch.float64)
    assert torch.equal(panels,
                       torch.arange(40, dtype=torch.float64).reshape(
                           10, 2, 2) + 3)
    assert prep == (Y.shape, "mgp", c.config["run"]["num_chains"],
                    c.traffic["thin"], "cpu")


@pytest.mark.parametrize("case", ["no_file", "no_key"])
def test_a_reference_that_is_not_there_is_an_error(case, tmp_path):
    c = tiny_cell("ns_mgp.fit")
    Y = data.make_data(c.config["data"], 1, "cpu")
    if case == "no_file":
        path = os.path.relpath(tmp_path / "absent.py", ROOT)
        config = dict(c.config, reference=path)
        with pytest.raises(FileNotFoundError) as e:
            check.reference(Y, config, c.traffic, 3, "cpu")
        assert path in str(e.value)
    else:
        config = {k: v for k, v in c.config.items() if k != "reference"}
        with pytest.raises(KeyError) as e:
            check.reference(Y, config, c.traffic, 3, "cpu")
    assert repr(c.config["name"]) in str(e.value)


def test_a_run_loads_its_reference_once_in_set_up(tmp_path, monkeypatch):
    """The run loads the named reference before the window and the
    comparison reuses it; a missing file fails before any fit."""
    c = tiny_cell("ns_mgp.fit")
    path = _reference_file(tmp_path, (
        "from fitref import gibbs\n"
        "posterior_mean = gibbs.posterior_mean\n"))
    loads = []
    load = spec.load_module
    monkeypatch.setattr(spec, "load_module",
                        lambda *a: loads.append(a) or load(*a))
    cell = spec.Cell(c.name, 1, dict(c.config, reference=path), c.traffic,
                     c.end_to_end, c.per_layer)
    out = runner.run_cell(cell, 7, 0.1, False, "cpu", time.perf_counter())
    assert out["correct"] is True and len(loads) == 1
    fits = []
    monkeypatch.setattr(runner.data, "make_data",
                        lambda *a: fits.append(a))
    absent = dict(c.config, reference=os.path.relpath(tmp_path / "no.py",
                                                      ROOT))
    with pytest.raises(FileNotFoundError, match="no.py"):
        runner.run_cell(dataclasses.replace(cell, config=absent), 7, 0.1,
                        False, "cpu", time.perf_counter())
    assert fits == []


@pytest.mark.parametrize("name,record", [("ns_mgp.fit", "MGP"),
                                         ("c5_hs_adapt.fit", "HORSESHOE")])
def test_a_reference_that_hands_over_its_prior(name, record, tmp_path):
    """A reference file of its own that passes the built-in record
    explicitly, under a prior name the built-in choice does not know,
    gives the built-in path's panels exactly."""
    c = tiny_cell(name)
    path = _reference_file(tmp_path, (
        "from fitref import gibbs\n"
        "def posterior_mean(Y, model, schedule, seed, chains, device, *,\n"
        "                   dtype):\n"
        "    return gibbs.posterior_mean(\n"
        "        Y, dict(model, prior='own'), schedule, seed, chains,\n"
        f"        device, dtype=dtype, prior=gibbs.{record})\n"))
    Y = data.make_data(c.config["data"], 1, "cpu")
    built_in, _ = check.reference(Y, c.config, c.traffic, 3, "cpu")
    own, _ = check.reference(Y, dict(c.config, reference=path), c.traffic,
                             3, "cpu")
    assert torch.equal(own, built_in)


def test_an_unknown_prior_is_refused_by_name():
    c = tiny_cell("ns_mgp.fit")
    Y = data.make_data(c.config["data"], 1, "cpu")
    model = dict(c.config["model"], **c.config["backend"], prior="dl")
    with pytest.raises(NotImplementedError, match="'dl'"):
        gibbs.posterior_mean(Y, model, c.traffic, 3, 2, "cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", CELLS)
def test_the_reference_panels_are_pinned(name, dtype):
    c = tiny_cell(name)
    Y = data.make_data(c.config["data"], 1, "cpu")
    panels, _ = check.reference(Y, c.config, c.traffic, 3, "cpu",
                                dtype=dtype)
    digest = hashlib.sha256(panels.contiguous().numpy().tobytes())
    assert digest.hexdigest() == DIGESTS[name, dtype]


def _fit_config_by_hand(config: dict, schedule: dict, seed: int):
    """The FitConfig built field by field from a fixed list of the
    sub-configs."""
    import dcfm_tpu_torch as dt

    model = dict(config["model"])
    for key, cls in (("mgp", dt.config.MGPConfig),
                     ("horseshoe", dt.config.HorseshoeConfig),
                     ("adapt", dt.config.AdaptConfig)):
        if key in model:
            model[key] = cls(**model[key])
    run = dict(config["run"], burnin=int(schedule["burnin"]),
               mcmc=int(schedule["mcmc"]), thin=int(schedule["thin"]),
               seed=int(seed))
    return dt.FitConfig(model=dt.ModelConfig(**model),
                        run=dt.RunConfig(**run),
                        backend=dt.BackendConfig(**config["backend"]),
                        **config["fit"])


@pytest.mark.parametrize("name", CELLS)
def test_fit_config_is_unchanged_for_the_cells(name):
    c = spec.load_cell(name)
    got = runner.fit_config(c.config, c.traffic, 2 ** 31 + 5)
    assert got == _fit_config_by_hand(c.config, c.traffic, 2 ** 31 + 5)


def test_fit_config_builds_every_sub_config():
    import dcfm_tpu_torch as dt

    c = spec.load_cell("ns_mgp.fit")
    config = dict(c.config, model=dict(c.config["model"], prior="dl",
                                       dl={"a": 0.25}))
    model = runner.fit_config(config, c.traffic, 7).model
    assert model.dl == dt.config.DLConfig(a=0.25)
    for f in dataclasses.fields(model):
        if dataclasses.is_dataclass(f.default):
            assert type(getattr(model, f.name)) is type(f.default)
    with pytest.raises(TypeError):
        runner.fit_config(dict(config, model=dict(config["model"],
                                                  dl={"b": 1.0})),
                          c.traffic, 7)
