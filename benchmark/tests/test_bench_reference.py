"""The plain reference against ``customnerf_torch`` at tiny widths on the
CPU, runs of both cells with the timed path broken underneath (``correct``
must come out false), the control, and the import check."""

from __future__ import annotations

import ast
import os

import pytest
import torch

from benchmark.lib import compare, registry
from benchmark.tests import tiny

SEED = 3_000_000_123
SEED_LOCAL = 3_000_000_128      # its first editing step: the local branch, the SDS part leading
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "customnerf_tpu"}


@pytest.fixture(autouse=True)
def _small_resize(monkeypatch):
    from customnerf_torch.engine import editing
    monkeypatch.setattr(editing, "RESIZE", tiny.TINY_VAE["sample_size"])


def _program(cfg, traffic, fault=None):
    from benchmark.lib import training
    job = registry.job(traffic["job"])
    kw = {"text_encoder": tiny.tiny_text_encoder()} if job.GUIDANCE else None
    prog = training.build(job, cfg, traffic, SEED, "unused", "cpu", guidance_kw=kw)
    w0 = training.initial_field(cfg, SEED, "cpu")
    with training.fault(fault):
        got = training.checked_steps(job, prog, traffic, w0)
    training.free(prog)
    return got


def _reference(cfg, traffic, **kw):
    return registry.job(traffic["job"]).readings(cfg, traffic, SEED, "cpu", **kw)


@pytest.mark.parametrize("cell, tol", [("recon", 1e-6), ("edit", 2e-2)])
def test_reference_follows_the_program_with_f32_heads(cell, tol):
    """With the f32 head (``--backend pallas``) the reconstruction steps
    agree to rounding; editing keeps the tri-plane table gradient's bf16
    operands (the configuration's precision), a few 1e-3 after Adam."""
    cfg, traffic = getattr(tiny, f"{cell}_cell")()
    cfg = dict(cfg, backend="pallas")
    got = _program(cfg, traffic)
    gaps = compare.gaps(got, _reference(cfg, traffic, follow=got))
    assert max(v for k, v in gaps.items() if k.endswith("_gap")) < tol, gaps


@pytest.mark.parametrize("cell", ["recon", "edit"])
def test_reference_follows_the_program_at_its_precision(cell):
    """The configuration's bf16 heads: within bf16's rounding, at most a
    tenth or so, on the CPU at tiny widths; the SDS gain within a half (at
    16² pixels the SDS part of a step's gradient is small beside the
    keep_bg term's rounding)."""
    cfg, traffic = getattr(tiny, f"{cell}_cell")()
    got = _program(cfg, traffic)
    gaps = compare.gaps(got, _reference(cfg, traffic, follow=got))
    assert max(v for k, v in gaps.items() if k.endswith("_gap") and k != "sds_gain_gap") \
        < 0.15, gaps
    assert gaps.get("sds_gain_gap", 0.0) < 0.5, gaps


@pytest.mark.parametrize("cell, fault, seed", [
    ("recon", "frozen", SEED), ("recon", "half_batch", SEED), ("edit", "frozen", SEED),
    ("edit", "half_batch", SEED), ("edit", "cotangent_negated", SEED),
    ("edit", "sds_scaled", SEED_LOCAL)])
def test_a_broken_step_is_not_correct(cell, fault, seed, monkeypatch):
    """A whole run on the CPU (the look for a card skipped) with the timed
    path broken underneath: ``correct`` comes out false, under the cell's
    own limits (the SDS gradient scaled on a seed whose first step takes
    the local branch with the SDS part leading, where its gain is read)."""
    from benchmark.lib import training
    cfg, traffic = getattr(tiny, f"{cell}_cell")()
    bench = tiny.bench()
    name = {"recon": "hashgrid-sd15.recon", "edit": "triplane-sd15.edit"}[cell]
    build = training.build
    if cell == "edit":
        monkeypatch.setattr(training, "build", lambda *a, **k: build(
            *a, **k, guidance_kw={"text_encoder": tiny.tiny_text_encoder()}))
    cell_entry = next(w for w in bench["workloads"] if w["name"] == name)
    with training.fault(fault):
        result, numbers, limits = training.run(registry.job(traffic["job"]), cell_entry, bench,
                                               cfg, traffic, seed, 0.1, False, 0.0,
                                               device="cpu")
    assert result["correct"] is False, numbers
    assert result["attempted"] > 0


@pytest.mark.parametrize("name", [w["name"] for w in tiny.bench()["workloads"]])
def test_the_chip_readings_are_judged_under_the_cells_limits(name):
    """The readings the limits were set from (``benchmark.calibrate`` on the
    card, kept in ``calibration/<cell>.jsonl``), judged again under the
    cell's limits file: every sound run correct (the program's, and the
    reference's at the configuration's own precision), the control and every
    planted fault not."""
    import json
    path = os.path.join(registry.HERE, "calibration", f"{name}.jsonl")
    rows = [json.loads(line) for line in open(path)]
    limits = registry.limits(name)
    sides = {r["side"] for r in rows}
    assert "program" in sides and "control" in sides
    assert len({r["seed"] for r in rows if r["side"] == "program"}) >= 12
    for r in rows:
        verdict = compare.judge(r, limits)
        sound = r["side"] in ("program", "reference_bf16")
        assert verdict is sound, (r["side"], r["seed"], verdict)


@pytest.mark.parametrize("cell", ["recon", "edit"])
def test_the_control_reads_worse_than_the_program(cell):
    """The reference a precision lower (fp8 operands in the heads and the
    SD stack, bf16 features) is farther from the reference than the
    program is."""
    from benchmark.reference import nerf
    cfg, traffic = getattr(tiny, f"{cell}_cell")()
    ref = _reference(cfg, traffic)
    prog = compare.gaps(_program(cfg, traffic), ref)
    low = _reference(cfg, traffic, prec=nerf.Precision(heads="fp8", features_bf16=True),
                     sd="fp8")
    ctl = compare.gaps(low, ref)
    assert max(ctl.values()) > max(prog.values()), (ctl, prog)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_nothing_imports_jax_and_the_reference_imports_no_program():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seen = 0
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
            if os.sep + "reference" + os.sep in path:
                assert "customnerf_torch" not in tops, path
            seen += 1
    assert seen > 20
    # a name that only begins like a forbidden one is not one of them
    assert "customnerf_torch".split(".")[0] not in FORBIDDEN


def test_run_refuses_without_a_card(monkeypatch, capsys):
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tiny.ROOT)
    assert run.main(["--workload", "hashgrid-sd15.recon", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _added_as_files(tmp_path, monkeypatch, cfg: dict, traffic: dict, name: str):
    """A configuration, a traffic mix and a cell added as files beside a
    copy of the benchmark, found by the harness by name."""
    import json
    import shutil
    here = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(registry, "HERE", str(here))
    (here / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (here / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    bench = dict(tiny.bench(), configs=[{"name": cfg["name"], "source": "test",
                                         "file": f"benchmark/configs/{cfg['name']}.json",
                                         "reduced": [], "why": "test"}],
                 workloads=[{"name": f"{cfg['name']}.{name}", "config": cfg["name"],
                             "traffic": name, "chips": 1, "why": "test"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = registry.benchmark(str(tmp_path))
    cell = registry.cell(bench, f"{cfg['name']}.{name}")
    return (registry.config(bench, cell["config"], str(tmp_path)),
            registry.traffic(cell["traffic"]))


def _hashgrid_edit():
    """``bear.sh --parity`` phase 2 at tiny widths: the tiled grid on the
    dense path under the editing recipe."""
    cfg, traffic = tiny.edit_cell()
    recon, _ = tiny.recon_cell()
    for key in ("O", "triplane_res", "triplane_channels"):
        cfg.pop(key)
    cfg.update({k: recon[k] for k in ("O2", "grid_type", "grid_levels", "grid_level_dim",
                                      "grid_base_resolution", "log2_hashmap_size",
                                      "desired_resolution", "num_steps", "upsample_steps")})
    return dict(cfg, name="tiny-hashgrid-edit"), dict(traffic, about="test")


def _triplane_recon():
    _, traffic = tiny.recon_cell()
    return tiny.triplane_recon_config(), dict(traffic, occupancy_warmup=2, about="test")


@pytest.mark.parametrize("make, parts, samples", [
    # -O: 16 × 16 rays in blocks of 16, each holding block_budget(16, 8, 0.35) = 128
    (_triplane_recon, {"k1", "dt"}, [16 * 128]),
    # -O2: a density-only coarse pass of 8 samples a ray, then 8 + 8
    (_hashgrid_edit, {"k1", "grid_encode", "unet"}, [16 * 16 * 8, 16 * 16 * 16])])
def test_a_new_path_and_field_are_added_as_files(make, parts, samples, tmp_path, monkeypatch):
    """A configuration whose render path and field no cell has yet (the
    tri-plane on ``-O`` reconstructing; the tiled grid on ``-O2`` editing),
    added with its traffic as files: its step's work is counted from its
    own shapes, and the plain reference follows the program, to rounding
    with the f32 head and within a tenth or two at the configuration's
    bf16."""
    from benchmark.lib import recipe, training
    cfg, traffic = _added_as_files(tmp_path, monkeypatch, *make(), name="mix")
    job = registry.job(traffic["job"])
    per_step, per_refresh, model = training.work(job, cfg, traffic, 0.5)
    assert set(per_step) == parts and model > 0
    assert [p.samples for p in recipe.field_passes(cfg, 16 * 16)] == samples
    assert bool(per_refresh) == recipe.fast(cfg)
    got = _program(dict(cfg, backend="pallas"), traffic)
    gaps = compare.gaps(got, _reference(dict(cfg, backend="pallas"), traffic, follow=got))
    assert max(v for k, v in gaps.items() if k.endswith("_gap")) < 1e-3, gaps
    got = _program(cfg, traffic)
    gaps = compare.gaps(got, _reference(cfg, traffic, follow=got))
    assert gaps["loss1_gap"] < 0.02 and gaps["grad_gap"] < 0.1, gaps


def test_run_prints_a_result_when_a_number_is_not_read(monkeypatch, capsys):
    """The main path on a run whose first step reads no SDS gain: the
    result is the last line, ``compared`` holds every limit (the unread
    number as None) and is the last key, and the compared lines end
    standard error."""
    import json
    from benchmark import run
    from benchmark.lib import training
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    numbers = {"loss1_gap": 0.001, "cot_gap": 0.04, "change1_gap": 0.0}

    def fake(job, cell, bench, cfg, traffic, *args):
        return ({"correct": compare.judge(numbers, registry.limits(cell["name"])),
                 "attempted": 1, "failed": 0, "metrics": {}, "device": {}},
                numbers, registry.limits(cell["name"]))
    monkeypatch.setattr(training, "run", fake)
    monkeypatch.chdir(tiny.ROOT)
    assert run.main(["--workload", "triplane-sd15.edit", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True and list(result)[-1] == "compared"
    assert result["compared"]["sds_gain_gap"]["value"] is None
    assert err.strip().splitlines()[-1].startswith("change1_gap")
