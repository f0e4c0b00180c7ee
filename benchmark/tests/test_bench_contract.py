"""``BENCHMARK.json`` against the benchmark's contract, the harness's
discovery of cells, configurations, traffic and metrics from files, and
the frozen operation and byte counts against hand counts."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark.lib import counts, readers, registry
from benchmark.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark(ROOT)


def test_names_units_and_keys_keep_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer",
                                      "moves"})):
        for m in bench[kind]:
            assert set(m) - {"workloads"} == keys, m
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for text in [c["why"] for c in bench["configs"] + bench["workloads"]] + \
            [m["layer"] for m in bench["per_layer"]] + bench["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        own = {m["name"] for m in registry.metrics_of(bench, w["name"], "end_to_end")}
        layer = registry.metrics_of(bench, w["name"], "per_layer")
        assert "setup_s" in own and len(own) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in own, (w["name"], m["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert all(b["bound"] <= 0.25 for b in bench["end_to_end"])


def test_every_named_file_exists(bench):
    for w in bench["workloads"]:
        assert w["traffic"] in registry.traffics()
        assert registry.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_a_cell_a_config_and_a_metric_are_added_as_files(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(registry, "HERE", str(here))
    (here / "configs" / "tiny-new.json").write_text('{"name": "tiny-new"}')
    (here / "traffic" / "burst.json").write_text('{"job": "recon"}')
    (here / "metrics" / "busy_ms.recon.py").write_text(
        "def read(r):\n    return 1e3 * r.trace.busy_s / r.steps\n")
    assert "tiny-new" in registry.configs() and "burst" in registry.traffics()
    assert "busy_ms.recon" in registry.metrics()
    bench = {"per_layer": [{"name": "busy_ms.recon", "workloads": ["x.burst"]}]}
    assert [m["name"] for m in registry.metrics_of(bench, "x.burst", "per_layer")] \
        == ["busy_ms.recon"]
    from benchmark.lib.trace import Trace
    r = readers.Traced(trace=Trace(window_s=2.0, busy_s=1.5), steps=10, refreshes=0)
    assert registry.reader("busy_ms.recon")(r) == pytest.approx(150.0)


def test_k1_counts_equal_a_hand_count():
    # 72 features in, 27 view features, 4 outputs, 64 wide
    macs = 72 * 64 + 64 * 64 * 3 + 64 + (27 + 64) * 64 + 64 * 4
    flops, nbytes = counts.k1_call(1000, 72, 27, 4, True)
    assert flops == 2 * macs * 1000
    assert nbytes == 1000 * (72 + 1 + 27 + 4) * 4 + macs * 4
    flops, nbytes = counts.k1_call(10, 32, 27, 4, False)
    assert flops == 2 * (32 * 64 + 3 * 64 * 64 + 64) * 10
    assert nbytes == 10 * 33 * 4 + (32 * 64 + 3 * 64 * 64 + 64) * 4


def test_dt_and_grid_counts_equal_a_hand_count():
    assert counts.dt_call(100, 40, 8, 4) == (8 * 4 * 40, 100 * 16 + 40 * 16 + 8 * 8 * 16)
    flops, nbytes = counts.grid_encode_step(30, 20, 16, 2, 1000)
    assert flops == 16 * 8 * 2 * 2 * 50
    assert nbytes == 30 * (3 + 32) * 4 + 20 * 32 * 4 + 2 * 1000 * 2 * 4


def test_sd_bytes_equal_a_hand_count():
    from benchmark.reference import sd
    u = sd.UNetConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                      cross_attention_dim=32, attention_head_dim=4, norm_num_groups=8)
    v = sd.VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                     norm_num_groups=8)
    got = counts.sd_counts(u, v, latent_hw=8, image_hw=64)
    unet = sd.build(sd.UNet2DCondition, u, device="meta")
    vae = sd.build(sd.AutoencoderKL, v, device="meta")
    n_u = sum(p.numel() for p in unet.parameters())
    n_e = sum(p.numel() for m in (vae.encoder, vae.quant_conv) for p in m.parameters())
    assert got["unet"][1] == 2 * n_u + 4 * (2 * 2 * 2 * 4 * 8 * 8 + 2 * 77 * 32)
    enc = 2 * n_e + 4 * (3 * 64 * 64 + 2 * 4 * 8 * 8)
    assert got["vae_forward"][1] == enc and got["vae_backward"][1] == 2 * enc
    # conv_in alone: 2 · out · in · 3 · 3 a pixel of the [2, 4, 8, 8] latents
    assert got["unet"][0] > 2 * 32 * 4 * 9 * 2 * 64
    assert got["vae_backward"][0] > got["vae_forward"][0] > 0


def test_idle_share_is_the_union_of_kernel_intervals():
    from benchmark.lib import trace
    w = trace.WINDOW
    rows = [(w, False, True, 0, 1000),
            ("k1", True, False, 100, 300), ("k2", True, False, 200, 400),
            ("ann", True, True, 0, 1000), ("cpu", False, False, 450, 900),
            ("k3", True, False, 900, 1200)]
    t = trace.reduce(rows)
    assert t.busy_s == pytest.approx(400e-9) and t.window_s == pytest.approx(1000e-9)
    assert readers.idle_share(readers.Traced(trace=t, steps=1, refreshes=0)) \
        == pytest.approx(60.0)
    assert t.gaps[0] == ["cpu", pytest.approx(500e-9)]
    assert t.kernel_s["k3"] == pytest.approx(100e-9)


@pytest.mark.parametrize("cell", ["edit", "recon"])
def test_the_work_of_a_step_is_counted_from_its_shapes(cell):
    from benchmark.lib import training
    from benchmark.tests import tiny
    cfg, traffic = getattr(tiny, f"{cell}_cell")()
    per_step, per_refresh, model = training.work(registry.job(traffic["job"]), cfg, traffic,
                                                 0.5)
    assert model > 0 and per_step["k1"]
    assert set(per_step) == ({"k1", "dt", "unet"} if cell == "edit" else {"k1", "grid_encode"})
    for items in per_step.values():
        assert all(f > 0 and b > 0 and p > 0 for f, b, p in items)
