"""Study builds of the port's two kernels, on the inputs of the main path.

    python -m tools.kernel_study [--dtable-baseline SOURCE.cu]

(from the repository root).  Drives the main path once through
``chip_smoke.run_trainer`` (the flagship recipe, 40 steps of 16,384 rays) and
keeps the inputs it gave each kernel: one step's and one refresh's for K1,
the last step's six planes for dT.  Then, beside the kernels the port builds:

* K1 (``csrc/fused_mlp.cu``) built with 16-row tiles
  (``-DCN_MLP_TILE_ROWS=16``), against the port's 32-row tiles;
* dT (``csrc/triplane_dtable.cu``) built at run lengths 1, 4, 16 and 32
  (``-DCN_DTABLE_RUN``) and without its atomics (``-DCN_DTABLE_NO_ATOMICS``,
  the time of everything else), against the port's run of 8;
* with ``--dtable-baseline``, another dT source with the same C interface
  (the parent commit's, say), timed the same way;
* the data of each plane: the share of live samples (nonzero cotangent),
  the cells they fall in, the most samples in one cell, where it lies (in
  the unit square, beside the camera's origin in the unit cube) and how many
  slots lie between its samples, how often two consecutive live samples
  share a cell, and how many (group, cell) pairs the live samples make for
  the kernel's runs of 8 and for blocks of 1,024 (the float4 flushes a merge
  inside such a group leaves, before corner sharing); and the port's dT on
  the samples sorted by cell (the most a merge could gain) beside the
  sort's own time.

Every variant is checked against the plain version and timed on the card
(device time, ``engine/measure.py``), dT into a zeroed block as the step
calls it; variants take turns, twice each, and the mean is reported.  Prints
one JSON line, also written to ``chiprun_out/kernel_study.json``.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

import chip_smoke
from customnerf_torch.engine.measure import captured_calls, card_line, device_ms
from customnerf_torch.engine.trainer import Trainer
from customnerf_torch.ops import fused_mlp as fm
from customnerf_torch.ops import kernels
from customnerf_torch.ops import triplane_kernels as tk

DT_RUNS = (1, 4, 16, 32)


def _start_build(name: str, source: str, defines=()):
    """nvcc of one source into build/libstudy_<name>.so, started now."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, f"libstudy_{name}.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *(f"-D{d}" for d in defines),
           "-I", kernels.CSRC_DIR, "-shared", source, "-o", so]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def _load(so: str, proc, symbol: str):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so}:\n{log}")
    lib = ctypes.CDLL(so)
    fn = getattr(lib, symbol)
    fn.argtypes = kernels._SIGNATURES[symbol]
    fn.restype = ctypes.c_int
    if symbol == "cn_fused_mlp_forward":
        lib.cn_fused_mlp_packed_floats.argtypes = \
            kernels._SIGNATURES["cn_fused_mlp_packed_floats"]
        lib.cn_fused_mlp_packed_floats.restype = ctypes.c_int
    return lib


def _stream():
    return torch.cuda.current_stream().cuda_stream


def k1_call(lib, x, v, ws, with_rgb):
    """One K1 launch from ``lib``, as ``fused_mlp_forward`` makes it."""
    B, in_dim = x.shape
    dir_dim, n_out = ws[5].shape[0] - fm.HIDDEN, ws[6].shape[1]
    sigma = torch.empty(B, device=x.device)
    rgb = torch.empty(B, n_out, device=x.device) if with_rgb else None
    packed = torch.empty(lib.cn_fused_mlp_packed_floats(
        in_dim, dir_dim, n_out, int(with_rgb)), device=x.device)
    kernels.check(lib.cn_fused_mlp_forward(
        x.data_ptr(), v.data_ptr() if with_rgb else None,
        *[w.data_ptr() for w in ws], packed.data_ptr(), sigma.data_ptr(),
        rgb.data_ptr() if with_rgb else None, B, in_dim, dir_dim, n_out,
        int(with_rgb), _stream()), "kernel_study K1")
    return sigma, rgb


def dt_call(lib, u0, v0, fu, fv, g, R, C, out):
    """One dT launch from ``lib`` into ``out``."""
    kernels.check(lib.cn_plane_dtable(
        u0.data_ptr(), v0.data_ptr(), fu.data_ptr(), fv.data_ptr(),
        g.data_ptr(), g.stride(0), out.data_ptr(), out.stride(0),
        u0.shape[0], R, C, _stream()), "kernel_study dT")
    return out


def _alternating(fns: dict, reps: int) -> dict:
    """Mean device ms of each call, the calls taking turns twice."""
    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            times[name].append(device_ms(fn, reps))
    return {name: sum(t) / len(t) for name, t in times.items()}


def study_k1(libs: dict, x, v, ws, with_rgb=True):
    want = fm.reference_forward(x, v, ws, with_rgb)
    errs = {}
    for name, lib in libs.items():
        got = k1_call(lib, x, v, ws, with_rgb)
        errs[name] = max(float((k - p).abs().max())
                         for k, p in zip(got, want) if p is not None)
    reps = 20 if x.shape[0] < 10 ** 6 else 5
    return {"B": x.shape[0], "with_rgb": with_rgb, "max_abs_err": errs,
            "ms": _alternating({name: lambda lib=lib: k1_call(lib, x, v, ws, with_rgb)
                                for name, lib in libs.items()}, reps)}


def study_dt(libs: dict, u0, v0, fu, fv, g, R, C):
    live = (g != 0).any(dim=1)
    cell = u0.long() * R + v0.long()
    lc = cell[live]
    cells, counts = torch.unique(lc, return_counts=True)
    hot = int(cells[counts.argmax()])
    hot_slots = torch.nonzero(live).squeeze(1)[lc == hot]
    slot = torch.arange(u0.shape[0], device=g.device)[live]

    def live_cells_in_groups_of(n):
        return int(torch.unique(slot // n * (R * R) + lc).numel())

    want = tk.plane_dtable_reference(u0, v0, fu, fv, g, R, C)
    scale = float(want.abs().max())
    out = torch.zeros(R * R, C, device=g.device)
    errs = {}
    for name, lib in libs.items():
        if name != "no_atomics":
            got = dt_call(lib, u0, v0, fu, fv, g, R, C, torch.zeros_like(out))
            errs[name] = float((got - want).abs().max()) / scale
    order = torch.argsort(cell)
    s_args = [t[order].contiguous() for t in (u0, v0, fu, fv, g)]
    port = libs["port"]
    return {
        "R": R, "C": C, "B": u0.shape[0],
        "live_share": float(live.float().mean()),
        "distinct_live_cells": int(counts.numel()),
        "max_samples_in_a_cell": int(counts.max()),
        "hottest_cell_unit": [hot // R / (R - 1), hot % R / (R - 1)],
        "hottest_cell_median_slot_gap": float(hot_slots.diff().float().median()),
        "consecutive_live_same_cell": float((lc[1:] == lc[:-1]).float().mean()),
        "live_cells_in_runs_of_8": live_cells_in_groups_of(8),
        "live_cells_in_blocks_of_1024": live_cells_in_groups_of(1024),
        "max_err_over_largest_sum": errs,
        "ms": _alternating({name: lambda lib=lib: dt_call(
            lib, u0, v0, fu, fv, g, R, C, out) for name, lib in libs.items()}, 20),
        "ms_sorted_by_cell": device_ms(lambda: dt_call(port, *s_args, R, C, out), 20),
        "ms_sort": device_ms(lambda: torch.argsort(cell), 20),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtable-baseline", metavar="SOURCE.cu",
                    help="another dT source with the same C interface")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_study: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    mlp_src = os.path.join(kernels.CSRC_DIR, "fused_mlp.cu")
    dt_src = os.path.join(kernels.CSRC_DIR, "triplane_dtable.cu")
    builds = {"k1_rows16": _start_build("k1_rows16", mlp_src, ["CN_MLP_TILE_ROWS=16"]),
              "no_atomics": _start_build("dt_no_atomics", dt_src, ["CN_DTABLE_NO_ATOMICS"])}
    for run in DT_RUNS:
        builds[f"run{run}"] = _start_build(f"dt_run{run}", dt_src, [f"CN_DTABLE_RUN={run}"])
    if args.dtable_baseline:
        builds["baseline"] = _start_build("dt_baseline", args.dtable_baseline)

    with captured_calls(Trainer, "train_step", keep=1) as last_step:
        _, mlp_inputs, dt_calls = chip_smoke.run_trainer()
    trainer, batch = last_step[-1][0][:2]
    bound = trainer.opt.bound
    origin = (batch.rays_o.mean(dim=0) + bound) / (2.0 * bound)

    port = kernels.library()
    k1_libs = {"rows32_port": port,
               "rows16": _load(*builds.pop("k1_rows16"), "cn_fused_mlp_forward")}
    dt_libs = {"port": port}
    dt_libs.update({name: _load(*b, "cn_plane_dtable") for name, b in builds.items()})

    result = {
        "card": card_line(),
        "camera_origin_unit": [float(c) for c in origin],
        "k1": [study_k1(k1_libs, *a, **kw) for a, kw in
               (mlp_inputs[chip_smoke.STEP_SAMPLES],
                mlp_inputs[chip_smoke.REFRESH_QUERIES])],
        # the six planes: (R, C) = (128, 16) for XY, XZ, YZ, then (512, 8)
        "dt": [study_dt(dt_libs, *a[:7]) for a, _ in dt_calls],
    }
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_study.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
