"""The program's side of a training cell: build the port's ``Trainer`` for
the configuration, hand it the seed's inputs, drive its first steps and
then its epochs through ``Trainer.train_one_epoch`` — the port's own loop:
groups of K steps, each group one dispatch of K replays of a captured step
(``Trainer.train_many`` for reconstruction, ``editing.editing_steps_many``
for editing), the occupancy refresh on the recipe's schedule, the losses
fetched once an epoch.

What differs between jobs comes from the job's module,
``benchmark/jobs/<job>.py`` (the traffic file's ``job``): whether it builds
the SD guidance (``GUIDANCE``), the rest of its set-up (``finish_setup``),
what its first step hands over besides Adam's state (``stash``), its plain
reference (``readings``) and the guidance's work a step
(``guidance_work``).  What the field does comes from the configuration
(``benchmark/lib/recipe.py``).

Set-up: the kernels built, the field and the guidance made and loaded with
the seed's weights, the occupancy grid refreshed past its warm-up, the
checked steps (each as an epoch of one step, so that Adam's state can be
read after the first and the parameters after the last), and, for editing,
steps until every view's pretrained render is cached.  The graph is
captured in the first checked step.  So the window holds nothing that
compiles, captures or renders a view for the first time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
import time

import torch

from benchmark.lib import compare, counts, inputs, readers, recipe, registry
from benchmark.lib import trace as trace_mod
from benchmark.reference import nerf
from benchmark.reference.train import initial_field

PORT_FLAGS_SKIP = {"name", "source", "unet", "vae", "precision", "parameters", "assumed",
                   "reduced_from", "table_rows"}


def port_args(cfg: dict) -> list:
    """The port's command line for the configuration's flags."""
    args = []
    for key, value in cfg.items():
        if key in PORT_FLAGS_SKIP:
            continue
        if key in ("O", "O2"):
            args += [f"-{key}"] if value else []
        elif isinstance(value, bool):
            args += [f"--{key}"] if value else []
        elif isinstance(value, list):
            args += [f"--{key}"] + [str(x) for x in value]
        else:
            args += [f"--{key}", str(value)]
    return args


@dataclasses.dataclass
class Program:
    trainer: object
    batches: list           # one RayBatch a view
    order: list             # the view of each step
    step: int = 0           # steps taken so far

    def take(self, n: int) -> list:
        out = [self.batches[self.order[i % len(self.order)]]
               for i in range(self.step, self.step + n)]
        self.step += n
        return out


def _quiet(*_args, **_kwargs):
    pass


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def port_sd_configs(cfg: dict) -> dict:
    """The port's UNet and VAE configs for the configuration's."""
    from customnerf_torch.guidance.unet import UNetConfig
    from customnerf_torch.guidance.vae import VAEConfig

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})
    return {"unet_cfg": pick(UNetConfig, cfg["unet"]), "vae_cfg": pick(VAEConfig, cfg["vae"])}


def build(job, cfg: dict, traffic: dict, seed: int, workspace: str, device="cuda",
          guidance_kw=None) -> Program:
    """The trainer of the cell, its weights the seed's, on the fast path its
    occupancy grid refreshed ``occupancy_warmup`` times.  ``guidance_kw``: more arguments
    of the port's ``StableDiffusionGuidance`` (a small text tower for the
    CPU tests)."""
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import RayBatch
    from customnerf_torch.engine.trainer import Trainer

    opt = parse_args(port_args(cfg) + [
        "--seed", str(inputs.program_seed(seed)), "--workspace", workspace,
        "--steps_per_dispatch", str(traffic["steps_per_dispatch"])])
    guidance = None
    if job.GUIDANCE:
        from customnerf_torch.guidance.sds import StableDiffusionGuidance
        guidance = StableDiffusionGuidance(opt, device=device, **port_sd_configs(cfg),
                                           **(guidance_kw or {}))
        inputs.fill_sd(guidance.unet, seed, 5, device)
        inputs.fill_sd(guidance.vae, seed, 6, device)
    tr = Trainer(opt, device=device, guidance=guidance, use_checkpoint="scratch", log=_quiet)
    weights = initial_field(cfg, seed, device)
    with torch.no_grad():
        for f in {id(tr.field): tr.field, id(tr.field_pretrained): tr.field_pretrained}.values():
            f.load_state_dict(weights)
    if guidance is not None:
        for name, z in inputs.embeddings(seed, device,
                                         cfg["unet"]["cross_attention_dim"]).items():
            setattr(tr, name, z)
    for _ in range(traffic["occupancy_warmup"] if recipe.fast(cfg) else 0):
        tr.update_extra_state()
    v = inputs.views(seed, traffic["views"], traffic["H"], traffic["W"], device)
    batches = [RayBatch(rgbs=v["rgbs"][i], mask=v["masks"][i], rays_o=v["rays_o"][i],
                        rays_d=v["rays_d"][i], H=traffic["H"], W=traffic["W"],
                        img_path=f"view_{i:03d}", index=i)
               for i in range(traffic["views"])]
    order = inputs.view_order(seed, traffic["views"], 100_000)
    return Program(tr, batches, order)


def checked_steps(job, prog: Program, traffic: dict, w0: dict) -> dict:
    """The first steps, each one epoch of one step through the window's
    call: each step's loss, the first step's gradient as Adam took it (its
    first moment after one update over 1 − β1: its norms, and itself on
    the host), what the job's ``stash`` holds of the first step, and each
    parameter's change after the first and after the last checked step."""
    tr = prog.trainer
    params = dict(tr.field.named_parameters())
    out = {"losses": []}
    for i in range(traffic["checked_steps"]):
        with job.stash(tr) if i == 0 else contextlib.nullcontext({}) as held:
            out["losses"].append(float(tr.train_one_epoch(prog.take(1))))
            out.update({k: v.detach().to("cpu", torch.float32, copy=True)
                        for k, v in held.items()})
        if i == 0:
            out["grad_vecs"] = {n: _first_moment(tr.optimizer, p) / 0.1
                                for n, p in params.items()}
            out["grads"] = {n: float(v.norm()) for n, v in out["grad_vecs"].items()}
            out["change1"] = _change(params, w0)
    out["change"] = _change(params, w0)
    return out


@torch.no_grad()
def _change(params: dict, w0: dict) -> dict:
    """The norm of each parameter's change since ``w0``."""
    return {n: float((p.detach() - w0[n]).norm()) for n, p in params.items()}


def _first_moment(optimizer, p):
    """Adam's first moment of ``p`` on the host (zeros where it holds
    none)."""
    m = optimizer.state.get(p, {}).get("exp_avg")
    return torch.zeros(p.shape) if m is None else m.detach().to("cpu", torch.float32, copy=True)


def window(prog: Program, traffic: dict, seconds: float) -> dict:
    """Epochs of ``epoch_steps`` steps until ``seconds`` have passed; the
    wall and the steps of all of them."""
    tr = prog.trainer
    steps, failed, ends = 0, 0, []
    _sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        n = traffic["epoch_steps"]
        avg = tr.train_one_epoch(prog.take(n))     # ends in a host read
        ends.append(time.perf_counter() - t0)
        steps += n
        if not math.isfinite(avg):
            failed += n
    _sync()
    wall = time.perf_counter() - t0
    print(f"[benchmark] epochs end at s: {ends}", file=sys.stderr)
    return {"wall_s": wall, "steps": steps, "failed": failed}


@contextlib.contextmanager
def labelled(owner, attr: str, label: str):
    """``owner.attr`` runs inside ``torch.profiler.record_function(label)``
    meanwhile (what the host was doing, for the trace's idle gaps)."""
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def free(prog: Program) -> None:
    """Drop the program's state and give its memory back."""
    tr = prog.trainer
    tr._graphs.clear()
    prog.trainer = prog.batches = None
    del tr
    import gc
    gc.collect()
    _sync()
    torch.cuda.empty_cache()


def workspace_dir() -> str:
    base = os.environ.get("TMPDIR") or os.path.join(os.getcwd(), "build")
    return os.path.join(base, "benchmark_workspace")


# ------------------------------------------------------------------ faults
@contextlib.contextmanager
def fault(name):
    """The timed path broken underneath, for the tests that see ``correct``
    come out false: ``frozen`` (a step returns its state unchanged: Adam
    never steps), ``half_batch`` (a training render takes the first half
    of the rays alone, the rest rendering nothing, and the losses take their
    means over that half), ``cotangent_negated`` (the guidance's SDS
    cotangent comes out negated where it is made) or ``sds_scaled`` (the
    editing loss takes twice the cotangent it is handed, so the field's SDS
    gradient doubles)."""
    if name is None:
        yield
        return
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.trainer import Trainer
    held = []

    def patch(owner, attr, new):
        held.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    if name == "frozen":
        base = Trainer.apply_gradients

        def frozen(self, loss, mark=None, optimizer=None, count=0):
            opt = optimizer or self.optimizer
            step = opt.step
            opt.step = lambda *a, **k: None
            try:
                base(self, loss, mark=mark, optimizer=optimizer, count=count)
            finally:
                opt.step = step
        patch(Trainer, "apply_gradients", frozen)
    elif name == "half_batch":
        base_render, base_loss, base_edit = Trainer.render, Trainer.loss, editing.editing_loss

        def pad(t, n, fill=None):
            rest = (fill if fill is not None else t.new_zeros(())).to(t.dtype)
            return torch.cat([t, rest.expand(n, *t.shape[1:])])

        def render(self, rays_o, rays_d, train, perturb, bg_color=None, field=None,
                   mark=None, occ=None):
            if not train:
                return base_render(self, rays_o, rays_d, train, perturb, bg_color, field,
                                   mark, occ)
            n = rays_o.shape[0] // 2
            out = base_render(self, rays_o[:n], rays_d[:n], train, perturb, bg_color,
                              field, mark, occ)
            rest = rays_o.shape[0] - n
            full = {}
            for k, v in out.items():
                if isinstance(v, dict) and k in ("fg", "bg"):
                    full[k] = {kk: pad(vv, rest) for kk, vv in v.items()}
                elif torch.is_tensor(v) and v.shape[:1] == (n,):
                    fill = bg_color if k == "image" and bg_color is not None else None
                    full[k] = pad(v, rest, fill)
                else:
                    full[k] = v
            return full

        def loss(self, out, rgbs, mask):
            n = out["image"].shape[0] // 2
            return base_loss(self, {k: v[:n] for k, v in out.items() if torch.is_tensor(v)},
                             rgbs[:n], mask[:n])

        def edit_loss(trainer, inputs_, out, latents, cotangent, H, W):
            out = dict(out, bg={k: v[:H * W // 2] for k, v in out["bg"].items()})
            inputs_ = dict(inputs_, pt_rgb_bg=inputs_["pt_rgb_bg"][:H // 2])
            return base_edit(trainer, inputs_, out, latents, cotangent, H // 2, W)
        patch(Trainer, "render", render)
        patch(Trainer, "loss", loss)
        patch(editing, "editing_loss", edit_loss)
    elif name == "cotangent_negated":
        from customnerf_torch.guidance.sds import StableDiffusionGuidance
        base_grad = StableDiffusionGuidance.sds_grad

        def negated(self, *args, **kwargs):
            grad, value = base_grad(self, *args, **kwargs)
            return -grad, value
        patch(StableDiffusionGuidance, "sds_grad", negated)
    elif name == "sds_scaled":
        base_edit = editing.editing_loss

        def scaled(trainer, inputs_, out, latents, cotangent, H, W):
            return base_edit(trainer, inputs_, out, latents, 2.0 * cotangent, H, W)
        patch(editing, "editing_loss", scaled)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, fn in reversed(held):
            setattr(owner, attr, fn)


# ------------------------------------------------------------ timed spans
def device_ms(fn, reps: int = 3) -> float:
    """Device ms of one call of ``fn``: the union of the intervals in which
    its operations ran on the card, traced over ``reps`` calls after one
    untraced call.  A call of a thousand launches is bound by the host's
    enqueue in eager mode; the union leaves the host's gaps out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace_mod.WINDOW):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return 1e3 * trace_mod.from_profiler(prof).busy_s / reps


@contextlib.contextmanager
def captured(owner, attr: str):
    """Calls of ``owner.attr`` meanwhile: (args, kwargs, grad enabled)."""
    fn = getattr(owner, attr)
    calls = []

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs, torch.is_grad_enabled()))
        return fn(*args, **kwargs)

    setattr(owner, attr, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, attr, fn)


def spans(prog: Program, traffic: dict) -> tuple:
    """One eager step with the port's calls captured, then each call timed
    on its own inputs: device ms a step, and dT's share of live samples."""
    import customnerf_torch.engine.trainer as trainer_mod
    import customnerf_torch.models.field as field_mod
    import customnerf_torch.ops.triplane as triplane_mod

    tr = prog.trainer
    out, live = {}, None
    with contextlib.ExitStack() as stack:
        grid = stack.enter_context(captured(field_mod, "grid_encode"))
        dts = stack.enter_context(captured(triplane_mod, "plane_dtable"))
        render = stack.enter_context(captured(trainer_mod, "render_rays_fast"))
        if tr.guidance is not None:
            unet = stack.enter_context(captured(tr.guidance.unet, "forward"))
            vae = stack.enter_context(captured(tr.guidance.vae, "encode"))
        tr.global_step += 1
        tr.train_step(prog.take(1)[0])
        torch.cuda.synchronize()
    if dts:
        live = sum(float((c[0][4] != 0).any(dim=1).float().mean()) for c in dts) / len(dts)
    if tr.guidance is not None:
        (a, kw, _), = unet
        with torch.no_grad():
            out["unet"] = device_ms(lambda: tr.guidance.unet(*a, **kw))
        (a, kw, _), = vae
        img = a[0].detach().requires_grad_(True)
        out["vae_encode"] = device_ms(lambda: tr.guidance.vae.encode(img, **kw))
    if render:
        a, kw, _ = render[-1]
        out["render"] = device_ms(lambda: trainer_mod.render_rays_fast(*a, **kw))
    if grid:
        parts = []
        for a, kw, grad in grid:
            x, table, spec = a[0].detach(), a[1], a[2]
            if grad:
                g = torch.randn(x.shape[0], spec.output_dim, device=x.device)

                def fwd_bwd(x=x, table=table, spec=spec, g=g):
                    field_mod.grid_encode(x, table, spec).backward(g)
                parts.append(device_ms(fwd_bwd))
            else:
                with torch.no_grad():
                    parts.append(device_ms(lambda x=x, table=table, spec=spec:
                                           field_mod.grid_encode(x, table, spec)))
        out["grid_encode"] = sum(parts)
    return out, live


VIEW_FEATURES, HEAD_OUT = 27, 4


def work(job, cfg: dict, traffic: dict, live: float | None) -> tuple:
    """Each measured part's launches a step as (flops, bytes, peak), the
    refresh's, and a step's model FLOPs, from the step's shapes: the
    field's passes on the configuration's path (``recipe.field_passes``)
    and the job's guidance.  ``live``: the share of samples dT finds live
    (all where unread)."""
    spec = recipe.encoder_spec(cfg)
    triplane = isinstance(spec, nerf.TriplaneSpec)
    bf16, f32 = counts.PEAK_BF16_FLOPS, counts.PEAK_F32_FLOPS
    per_step, per_refresh, model = {"k1": []}, {}, 0.0
    points_fwd = points_bwd = 0
    for p in recipe.field_passes(cfg, traffic["H"] * traffic["W"]):
        flops, nbytes = counts.k1_call(p.samples, spec.output_dim, VIEW_FEATURES, HEAD_OUT,
                                       p.grad)
        per_step["k1"].append((flops, nbytes, bf16))
        model += 3 * flops if p.grad else flops
        points_fwd += p.samples
        points_bwd += p.samples if p.grad else 0
        if p.grad and triplane:
            share = 1.0 if live is None else live
            per_step.setdefault("dt", []).extend(
                (*counts.dt_call(p.samples, share * p.samples, R, C), f32)
                for R, C in zip(spec.resolutions, spec.channels) for _ in range(3))
    if not triplane:
        per_step["grid_encode"] = [(*counts.grid_encode_step(
            points_fwd, points_bwd, spec.num_levels, spec.level_dim, spec.table_size), f32)]
    q = recipe.refresh_points(cfg)
    if q:
        per_refresh["k1"] = (*counts.k1_call(q, spec.output_dim, VIEW_FEATURES, HEAD_OUT,
                                             False), bf16)
    guidance, guidance_flops = job.guidance_work(cfg)
    per_step.update(guidance)
    return per_step, per_refresh, model + guidance_flops


def traced(job, prog: Program, cfg: dict, traffic: dict) -> readers.Traced:
    """One epoch under ``torch.profiler``, then the spans."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from customnerf_torch.engine import editing
    from customnerf_torch.engine.dispatch import StepGraph

    tr = prog.trainer
    n_refresh = [0]
    refresh = tr.update_extra_state

    def counted():
        n_refresh[0] += 1
        refresh()

    tr.update_extra_state = counted
    with labelled(tr, "update_extra_state", "benchmark.refresh"), \
            labelled(editing, "editing_inputs", "benchmark.pre_pass"), \
            labelled(StepGraph, "replay", "benchmark.replay"), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function(trace_mod.WINDOW):
            tr.train_one_epoch(prog.take(traffic["epoch_steps"]))
            torch.cuda.synchronize()
    tr.update_extra_state = refresh
    trace = trace_mod.from_profiler(prof)
    del prof
    spans_ms, live = spans(prog, traffic)
    per_step, per_refresh, model = work(job, cfg, traffic, live)
    steps = traffic["epoch_steps"]
    if n_refresh[0] and "k1" in per_refresh:
        model += n_refresh[0] * per_refresh["k1"][0] / steps
    return readers.Traced(trace=trace, steps=steps, refreshes=n_refresh[0], spans=spans_ms,
                          work=per_step, refresh_work=per_refresh, model_flops=model)


# --------------------------------------------------------------------- run
def program_readings(job, cfg, traffic, seed, device):
    """The program's checked steps alone (set-up, no window), its state
    freed: for the calibration of the limits."""
    prog = build(job, cfg, traffic, seed, workspace_dir(), device)
    got = checked_steps(job, prog, traffic, initial_field(cfg, seed, device))
    free(prog)
    return got


def run(job, cell: dict, bench: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, t_start: float, device="cuda") -> tuple:
    """One run of a cell: (result line without ``compared``, the compared
    numbers, their limits)."""
    limits = registry.limits(cell["name"])
    marks = [("start", time.perf_counter() - t_start)]
    prog = build(job, cfg, traffic, seed, workspace_dir(), device)
    marks.append(("built", time.perf_counter() - t_start))
    w0 = initial_field(cfg, seed, device)
    got = checked_steps(job, prog, traffic, w0)
    marks.append(("checked", time.perf_counter() - t_start))
    job.finish_setup(prog, traffic)
    _sync()
    del w0
    setup_s = time.perf_counter() - t_start
    marks.append(("setup", setup_s))
    print(f"[benchmark] set-up s: {marks}", file=sys.stderr)
    metrics, attempted, failed, extra = {}, 0, 0, {}
    if trace:
        t = traced(job, prog, cfg, traffic)
        attempted = t.steps
        for m in registry.metrics_of(bench, cell["name"], "per_layer"):
            value = registry.reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": t.trace.busy_s, "window_s": t.trace.window_s}
        breakdown = {"device_ops": t.trace.top(10), "idle_gaps": t.trace.gaps[:10]}
    else:
        w = window(prog, traffic, seconds)
        attempted, failed = w["steps"], w["failed"]
        rays = traffic["H"] * traffic["W"]
        values = {"setup_s": setup_s,
                  "edit_step_ms": 1e3 * w["wall_s"] / w["steps"],
                  "recon_rays_per_s": w["steps"] * rays / w["wall_s"]}
        for m in registry.metrics_of(bench, cell["name"], "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    if "peak_gb" in [m["name"] for m in registry.metrics_of(bench, cell["name"], "end_to_end")] \
            and not trace:
        metrics["peak_gb"] = {"value": peak / 1e9, "unit": "GB"}
    free(prog)
    ref = job.readings(cfg, traffic, seed, device, follow=got)
    numbers = compare.gaps(got, ref)
    result = {"correct": compare.judge(numbers, limits), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": dict(_device(device, peak), **extra)}
    if trace:
        result["breakdown"] = breakdown
    print(f"[benchmark] numbers {numbers}", file=sys.stderr)
    print(f"[benchmark] program {_brief(got)}", file=sys.stderr)
    print(f"[benchmark] reference {_brief(ref)}", file=sys.stderr)
    return result, numbers, limits


def _brief(readings: dict) -> dict:
    """The readings without their tensors."""
    return {k: v for k, v in readings.items()
            if k in ("losses", "grads", "change1", "change", "branches")}


def _device(device, peak) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak), "card": card_line()}


def card_line() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi: {e}"
