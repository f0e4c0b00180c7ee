"""LGIE editing: Local-Global Iterative Editing with SDS guidance
(counterpart of ``customnerf_tpu/engine/editing.py``): one scene a step, or
N scenes × M prompts a step (:func:`editing_step_scenes`).

A step is a host pre-pass and a device step.  The pre-pass
(:func:`editing_inputs`, the JAX order of ``editing.py:441-476``) draws the
bg colour, takes the pt render from the cache (rendered the first time a
view appears), picks ``--clip_view``'s prompt, draws the LGIE gate and t;
its results are tensors.  The device step (:func:`editing_body`) reads only
those tensors: ``use_fg`` selects the image with a ``torch.where``, as the
JAX ``jnp.where(use_fg > 0.5, …)`` does, and t is a device tensor.  So the
eager :func:`editing_step` and the K-step :func:`editing_steps_many` (on the
card, replays of one captured device step) share both halves.

One step renders the full frame once with the graph, resizes the chosen
image (full, or foreground under the local branch) bilinear to the
guidance VAE's ``sample_size`` (512², SDXL's 1024²),
VAE-encodes it with the graph, runs the UNet without a graph on the detached
latents for the SDS cotangent, then backpropagates
``sum(latents · cotangent) + keep_bg · L1(pt_bg, pred_bg)`` and takes the
Adam step — the gradient of the JAX package's three programs
(``prog_a``/``prog_b``/``prog_c``), with the render run once as in its
``_build_editing_many``.

Kept exact (reference ``nerf/utils_init_nerf.py:243-394``):
  * the frozen-model render cache per ``img_path``, filled with the bg
    colour of the first step that touches it, ``perturb=True``; the fg/bg
    composites stay unfilled;
  * ``--random_bg_c`` / ``--black_bg_c`` / ``--white_bg_c`` and ``--ori_bg``;
  * the LGIE gate (``--g_only`` / ``--l_only`` / Bernoulli(global_ratio))
    drawn from ``numpy.random.RandomState(opt.seed)``, the JAX package's
    stream; the local branch takes ``text_z_fg`` and ``local_t_ratio``;
  * ``--clip_view``: the prompt of the view CLIP matches the pt render to.

Under ``--sd_version xl`` and ``flux-dev`` each prompt's embedding is a
``PooledText`` (the context and SDXL's or FLUX's pooled embedding): it goes
wherever a ``text_z*`` goes (per view under ``--clip_view``, the LGIE gate)
and into the device step's inputs as ``text_emb`` and ``text_pooled``.  The
latents have the guidance VAE's channels (4, FLUX's 16).  Multi-scene
editing refuses xl and flux-dev.

The bg colour, t and both noises come from the trainer's ``torch.Generator``
(not ``jax.random``'s streams); ``draws`` hands them in for tests.

Under ``--mesh_shape data:k`` the render of a step is sharded over the
ranks and gathered (``Trainer.render``); the resize, the VAE, the UNet and
the loss then run on the whole frame on every rank, with the same draws
(the generators stay in step), and the gradients are summed over the axis
before Adam.  A ray count that does not divide k is edge-padded and the
padded rays are cut off before the loss (``parallel/mesh.py::RayShard``,
JAX ``editing.py:305-322``).

Multi-scene editing (:func:`editing_step_scenes`, JAX ``editing.py:505-723``)
takes S scenes' fields and Adam states stacked on a leading scene axis.
The render, the VAE encode, the backward and Adam run per scene (each
scene's field through the kernels as a single-scene step runs them); the
SDS ε-prediction of all S scenes is ONE UNet call of batch 2S
(``guidance/sds.py::sds_grad_batch``).  Under ``--mesh_shape
scene:s,data:d`` each rank takes its S/s scenes, their rays sharded over
``data``, and the results are gathered over ``scene``.

The tracer's spans (``engine/spans.py``): the host spans ``pre_pass``
and, on a pt-cache miss, ``pt_render`` (counted); the device spans of a step
``edit.step`` › ``render`` (› the renderer's stages), ``resize``,
``vae_encode``, ``unet`` (the SDS ε call with its CFG batch; under
flux-dev ``dit``, the transformer's one call), ``loss``,
``backward`` › (``vae_encode.bwd``, ``resize.bwd``, ``render.bwd``, stamped
by gradient hooks where the latents', the resized image's and the frame's
gradients are complete) and ``adam``.  A multi-scene step has the same
spans, a scene's render, VAE, loss, backward and Adam once a scene.

Dtypes along the step, as in the JAX package: the render and the resized
image are f32; the VAE encodes in the guidance's dtype (bf16 on the card)
and gives f32 latents; the UNet casts them to its dtype and gives f32 ε;
the SDS cotangent, the surrogate loss and the gradient into the NeRF are
f32.
"""

from __future__ import annotations

import contextlib
import copy

import torch
import torch.nn.functional as F

from customnerf_torch.engine import spans
from customnerf_torch.guidance.clip_view import VIEW_NAMES
from customnerf_torch.guidance.text import PooledText
from customnerf_torch.ops.occupancy import OccupancyState
from customnerf_torch.parallel.mesh import all_gather_cat

# the side of the square image the VAE encodes (reference sd.py:99) is the
# guidance VAE's sample_size (512, SDXL's 1024); a number here overrides it,
# which only benchmark/tests/test_bench_reference.py still sets (to its tiny
# VAE's own sample_size)
RESIZE = None


def resize_side(trainer) -> int:
    """The side of the square image the step's VAE encodes."""
    return RESIZE or trainer.guidance.vae.cfg.sample_size


def _embed(trainer, text):
    """One prompt's [uncond; cond] embedding, per view under --clip_view."""
    opt, guidance = trainer.opt, trainer.guidance
    if opt.clip_view:
        return [guidance.get_text_embeds([f"{text}, {d} view"], [opt.negative])
                for d in VIEW_NAMES]
    return guidance.get_text_embeds([text], [opt.negative])


def prepare_text_embeddings(trainer):
    """Embed text / text_fg / text_norm / text_fg_norm / text_bg, per view
    under --clip_view (utils_init_nerf.py:310-351)."""
    opt, guidance = trainer.opt, trainer.guidance
    embed = lambda text: _embed(trainer, text)               # noqa: E731
    trainer.text_z = embed(opt.text)
    trainer.text_z_fg = embed(opt.text_fg)
    trainer.text_z_norm = embed(opt.text_norm)
    trainer.text_z_norm_fg = embed(opt.text_fg_norm)
    trainer.text_z_bg = guidance.get_text_embeds([opt.text_bg], [opt.negative])

    if opt.clip_view and getattr(trainer, "clip_matcher", None) is None:
        if not opt.clip_weights and not opt.allow_random_guidance:
            raise RuntimeError(
                "--clip_view without --clip_weights: view matching would use "
                "a RANDOM CLIP and pick arbitrary prompts. Provide "
                "--clip_weights or pass --allow_random_guidance.")
        from customnerf_torch.guidance.clip_view import CLIPViewMatcher
        trainer.clip_matcher = CLIPViewMatcher(weights_dir=opt.clip_weights,
                                               seed=opt.seed,
                                               device=trainer.device)


def _get_pt(trainer, batch, bg_color, field=None, cache_key=None):
    """The frozen-model render of ``batch``'s image, computed once per
    img_path (utils_init_nerf.py:243-265), with its ``--clip_view`` prompt
    index (the argmax view, read once here).  Multi-scene editing renders
    each scene's frozen ``field`` under its own ``cache_key`` ``(scene,
    img_path)``, on the trainer's occupancy grid, as the JAX ``_get_pt``
    does."""
    cache_key = cache_key if cache_key is not None else batch.img_path
    if cache_key in trainer.pt_dict:
        return trainer.pt_dict[cache_key]
    field = field if field is not None else trainer.field_pretrained
    with spans.span("pt_render", counter="pt_render"):
        out = trainer.render_image(batch.rays_o, batch.rays_d, perturb=True,
                                   bg_color=bg_color, field=field)
        H, W = batch.H, batch.W
        pt_rgb = out["image"].reshape(H, W, 3)
        match_probs = None
        if trainer.opt.clip_view:
            match_probs = trainer.clip_matcher.match_probs(pt_rgb[None])[0]
    entry = dict(pt_rgb_bg=out["bg"]["image"].reshape(H, W, 3),
                 pt_rgb_fg=out["fg"]["image"].reshape(H, W, 3),
                 pt_mask=out["render_mask"].reshape(H, W, -1),
                 pt_depth_fg=out["fg"]["depth"].reshape(H, W, 1),
                 match_probs=match_probs)
    trainer.pt_dict[cache_key] = entry
    return entry


def _select_text(trainer, pt, text_z=None, text_z_fg=None):
    """--clip_view: the argmax view's prompts (utils_init_nerf.py:267-280);
    the view index is read on the host once a pt entry.  ``text_z`` /
    ``text_z_fg`` replace the trainer's (a scene's own prompts)."""
    text_z = text_z if text_z is not None else trainer.text_z
    text_z_fg = text_z_fg if text_z_fg is not None else trainer.text_z_fg
    if trainer.opt.clip_view and pt.get("match_probs") is not None:
        if "text_sel" not in pt:
            pt["text_sel"] = int(pt["match_probs"].argmax())
        sel = pt["text_sel"]
        return text_z[sel], text_z_fg[sel]
    return text_z, text_z_fg


def _bg_color(trainer, scene: bool = False):
    """The step's bg colour; a multi-scene step's is never None (JAX
    ``editing.py:653-658``)."""
    opt, dev = trainer.opt, trainer.device
    if opt.random_bg_c:
        return torch.rand(3, generator=trainer.generator, device=dev)
    if scene:
        return torch.full((3,), 1.0 if opt.white_bg_c else 0.0, device=dev)
    if opt.black_bg_c:
        return torch.zeros(3, device=dev)
    if opt.white_bg_c:
        return torch.ones(3, device=dev)
    return None


def _lgie_gate(trainer, text_z, text_z_fg):
    """(use the fg image, text embedding, t ratio): utils_init_nerf.py:286-301."""
    opt = trainer.opt
    if opt.g_only:
        return False, text_z, 1.0
    if opt.l_only:
        return True, text_z_fg, opt.local_t_ratio
    if trainer.np_rng.random() < opt.global_ratio:
        return False, text_z, 1.0
    return True, text_z_fg, opt.local_t_ratio


def editing_inputs(trainer, batch, draws=None, scene=None):
    """The host pre-pass (host span ``pre_pass``) of one step at the
    current ``global_step``: the bg colour, the pt entry, the prompt, the
    LGIE gate and t, in the JAX order (``editing.py:441-476``).  Returns
    (inputs, local): ``inputs`` holds the tensors :func:`editing_body` reads (``use_fg`` a 0-d f32, t a
    [1] int64); ``local`` is the gate's branch.  ``draws`` may fix
    ``bg_color`` and ``t``.  ``scene`` (a scene of
    :func:`editing_step_scenes`): its ``index``, frozen ``field``, ``occ``
    grid and optional ``text_z`` / ``text_z_fg``; its pt entry is keyed
    ``(index, img_path)`` and rendered with the bg colour only under
    ``--random_bg_c`` (on the trainer's grid), it has no ``--ori_bg`` target (JAX
    ``editing.py:649-678``), and ``inputs`` carry its ``occ``."""
    with spans.span("pre_pass"):
        return _editing_inputs(trainer, batch, draws, scene)


def _editing_inputs(trainer, batch, draws, scene):
    opt, guidance, dev = trainer.opt, trainer.guidance, trainer.device
    if guidance is None:
        raise RuntimeError("editing needs the SD guidance (--lambda_sd > 0)")
    draws = draws or {}
    if not hasattr(trainer, "text_z"):
        prepare_text_embeddings(trainer)
    bg_color = (draws["bg_color"] if "bg_color" in draws
                else _bg_color(trainer, scene=scene is not None))
    if scene is None:
        scene = {}
        pt = _get_pt(trainer, batch, bg_color)
    else:
        pt = _get_pt(trainer, batch, bg_color if opt.random_bg_c else None,
                     field=scene["field"], cache_key=(scene["index"], batch.img_path))
    text_z, text_z_fg = _select_text(trainer, pt, scene.get("text_z"),
                                     scene.get("text_z_fg"))
    use_fg, text_emb, t_ratio = _lgie_gate(trainer, text_z, text_z_fg)
    pooled = None
    if isinstance(text_emb, PooledText):
        text_emb, pooled = text_emb
    if "t" in draws:
        t = torch.as_tensor(draws["t"], dtype=torch.int64, device=dev).reshape(1)
    else:
        t = guidance.sample_timestep(trainer.generator, trainer.global_step,
                                     t_ratio)
    inputs = {"rays_o": batch.rays_o, "rays_d": batch.rays_d,
              "pt_rgb_bg": pt["pt_rgb_bg"], "text_emb": text_emb, "t": t,
              "use_fg": torch.full((), float(use_fg), device=dev)}
    if pooled is not None:
        inputs["text_pooled"] = pooled
    if bg_color is not None:
        inputs["bg_color"] = torch.as_tensor(bg_color, dtype=torch.float32,
                                             device=dev)
    if "occ" in scene:
        inputs["occ"] = scene["occ"]
    elif opt.ori_bg:
        inputs["gt"] = batch.rgbs
        inputs["pt_mask"] = pt["pt_mask"]
    return inputs, use_fg


def editing_latents(trainer, inputs, H: int, W: int, perturb: bool = True,
                    draws=None, field=None):
    """The step up to the UNet: render ``field`` (default the trainer's) on
    ``inputs``' ``occ`` (default the trainer's grid), resize, VAE encode
    with the graph, and the SDS noise.  ``draws`` may fix ``noise`` and
    ``vae_noise``.  Returns (render outputs, latents, noise); latents and
    noise are None without ``--lambda_sd``."""
    opt, guidance = trainer.opt, trainer.guidance
    draws = draws or {}
    with spans.device("render"):
        out = trainer.render(inputs["rays_o"], inputs["rays_d"], train=True,
                             perturb=perturb, bg_color=inputs.get("bg_color"),
                             field=field, occ=inputs.get("occ"))
    if not opt.lambda_sd:
        return out, None, None
    n = H * W
    side = resize_side(trainer)
    with spans.device("resize"):
        fg = out["fg"]["image"] if "fg" in out else out["image"]
        frame = torch.where(inputs["use_fg"] > 0.5, fg, out["image"])
        frame = frame[:n].reshape(1, H, W, 3).permute(0, 3, 1, 2)
        img = F.interpolate(frame, size=(side, side), mode="bilinear",
                            align_corners=False, antialias=True)
    with spans.device("vae_encode"):
        latents = guidance.encode_imgs(img, generator=trainer.generator,
                                       noise=draws.get("vae_noise"))
    # the backward's stages, stamped where each gradient is complete
    spans.at_grad(latents, begins="vae_encode.bwd")
    spans.at_grad(img, ends="vae_encode.bwd", begins="resize.bwd")
    spans.at_grad(frame, ends="resize.bwd", begins="render.bwd")
    noise = draws.get("noise")
    if noise is None:
        noise = torch.randn(latents.shape, generator=trainer.generator,
                            device=latents.device)
    return out, latents, torch.as_tensor(noise, device=latents.device)


def editing_loss(trainer, inputs, out, latents, cotangent, H: int, W: int):
    """``sum(latents · cotangent) + keep_bg · L1(target_bg, pred_bg)``, the
    target the pt render, or under ``--ori_bg`` (``inputs`` with ``gt``)
    the ground truth where neither render covers.  Returns (loss, loss_bg
    or None)."""
    opt = trainer.opt
    n = H * W
    loss = (latents * cotangent).sum() if latents is not None else 0.0
    if not opt.keep_bg:
        return loss, None
    pred_rgb_bg = out["bg"]["image"][:n].reshape(H, W, 3)
    target_bg = inputs["pt_rgb_bg"]
    if "gt" in inputs:
        pred_mask = out["render_mask"][:n].reshape(H, W, -1)
        non_edit = (inputs["pt_mask"].mean(-1, keepdim=True)
                    + pred_mask.mean(-1, keepdim=True)) < 0.5
        target_bg = torch.where(non_edit, inputs["gt"][:n].reshape(H, W, 3),
                                target_bg)
    loss_bg = opt.keep_bg * (target_bg - pred_rgb_bg).abs().mean()
    return loss + loss_bg, loss_bg


def editing_body(trainer, inputs, H: int, W: int, perturb: bool = True,
                 draws=None):
    """The device step (device span ``edit.step``): :func:`editing_latents`,
    the SDS cotangent (UNet without a graph), :func:`editing_loss`, backward
    and Adam.  Reads only ``inputs`` (from :func:`editing_inputs`) and the
    trainer's state.  Returns ({``loss_sds``, ``loss_bg``: detached}, render
    stats)."""
    with spans.device("edit.step"):
        out, latents, noise = editing_latents(trainer, inputs, H, W, perturb, draws)
        aux, cotangent = {}, None
        if latents is not None:
            with spans.device(trainer.guidance.span):
                cotangent, aux["loss_sds"] = trainer.guidance.sds_grad(
                    latents.detach(), inputs["text_emb"], inputs["t"], noise,
                    pooled=inputs.get("text_pooled"))
        with spans.device("loss"):
            loss, loss_bg = editing_loss(trainer, inputs, out, latents, cotangent, H, W)
        if loss_bg is not None:
            aux["loss_bg"] = loss_bg
        trainer.apply_gradients(loss)
    return {k: v.detach() for k, v in aux.items()}, out["stats"]


def editing_step(trainer, batch, perturb: bool = True, draws=None):
    """One eager LGIE editing step.  Returns (loss, aux, render stats):
    ``aux`` holds ``loss_sds`` (0.5·Σ grad², the reference's value) and
    ``loss_bg``, ``loss`` their sum.  ``draws`` may fix ``bg_color``, ``t``,
    ``noise`` (the SDS ε) and ``vae_noise`` (the posterior sample's ε).
    The stats add the LGIE branch (``local``) and ``t``."""
    inputs, local = editing_inputs(trainer, batch, draws)
    aux, stats = editing_body(trainer, inputs, batch.H, batch.W,
                              perturb=perturb, draws=draws)
    return sum(aux.values()), aux, dict(stats, local=local, t=inputs["t"])


def editing_steps_many(trainer, batches, draws=None):
    """``len(batches)`` editing steps in one dispatch (JAX
    ``editing.py:423-503``), each at its own ``global_step`` (incremented
    here per step, as there).  Each step's pre-pass runs on the host just
    before its device step, so the generator's draws come in the eager
    order; the device steps are replays of one captured
    :func:`editing_body` on the card and eager calls on the CPU.
    ``draws`` (the CPU only): one dict a step, as :func:`editing_step`
    takes.  All views
    share one image shape.  Returns (losses [K], aux {name: [K]}) on the
    device."""
    if draws and trainer.device.type != "cpu":
        raise ValueError("draws= fixes eager steps' draws; on the card a "
                         "dispatch replays one captured step")
    H, W = int(batches[0].H), int(batches[0].W)
    outs = []
    for j, batch in enumerate(batches):
        trainer.global_step += 1
        d = draws[j] if draws else None
        inputs, _ = editing_inputs(trainer, batch, d)
        outs += trainer._dispatch(
            "edit", lambda x: editing_body(trainer, x, H, W, draws=d)[0], [inputs])
    losses = torch.stack([sum(o.values()) for o in outs])
    return losses, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ------------------------------------------------------------- N scenes
def stack_trees(trees):
    """Stack identically structured trees (tensors, dicts, lists, tuples,
    ``OccupancyState``) on a new leading scene axis; a stacked
    ``OccupancyState`` keeps one ``iter_density`` a scene in a list."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(trees))
    if isinstance(first, OccupancyState):
        return OccupancyState(
            density_grid=torch.stack([t.density_grid for t in trees]),
            bitfield=torch.stack([t.bitfield for t in trees]),
            mean_density=torch.stack([t.mean_density for t in trees]),
            iter_density=[t.iter_density for t in trees],
            grid_size=first.grid_size)
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees(list(xs)) for xs in zip(*trees))
    raise TypeError(f"stack_trees: cannot stack {type(first).__name__}")


def _occ_of(occ_s: OccupancyState, i: int) -> OccupancyState:
    """Scene ``i``'s grid of stacked occupancy states."""
    return OccupancyState(density_grid=occ_s.density_grid[i], bitfield=occ_s.bitfield[i],
                          mean_density=occ_s.mean_density[i],
                          iter_density=occ_s.iter_density[i], grid_size=occ_s.grid_size)


def prepare_scene_prompts(trainer, text: str, text_fg: str) -> dict:
    """One scene's prompt pair for multi-scene editing (N scenes × M
    prompts), per view under --clip_view as :func:`prepare_text_embeddings`
    embeds them: a ``scenes[i]`` entry of :func:`editing_step_scenes`."""
    return {"text_z": _embed(trainer, text), "text_z_fg": _embed(trainer, text_fg)}


@contextlib.contextmanager
def _drawing_from(trainer, generator):
    """The trainer's renders and draws take ``generator`` meanwhile."""
    held = trainer.generator
    trainer.generator = generator
    try:
        yield
    finally:
        trainer.generator = held


def _scene_slots(trainer, n: int):
    """``n`` (field, Adam) pairs shaped as the trainer's, kept across steps;
    a step points a slot's parameters and moments at a scene's rows of the
    stacked state (:func:`_bind_scene`)."""
    slots = trainer.__dict__.setdefault("_scene_slots", [])
    while len(slots) < n:
        field = copy.deepcopy(trainer.field).requires_grad_(True)
        slots.append((field, trainer.make_optimizer(field)))
    return slots[:n]


def _frozen_field(trainer, i: int, params):
    """Scene ``i``'s frozen pretrained field: the trainer's, or one holding
    ``params`` (a state dict), kept while the same dict is given."""
    if params is None:
        return trainer.field_pretrained
    held = trainer.__dict__.setdefault("_scene_pretrained", {})
    if i not in held or held[i][0] is not params:
        field = copy.deepcopy(trainer.field_pretrained)
        field.load_state_dict(params)
        held[i] = (params, field.requires_grad_(False))
    return held[i][1]


def _bind_scene(slot, params, moments, j: int, count: float):
    """Point the slot's parameters and Adam moments at row ``j`` of the
    stacked ``params`` / ``moments`` (``exp_avg``, ``exp_avg_sq``), which
    the update then writes in place, at update ``count``."""
    field, adam = slot
    for name, p in field.named_parameters():
        p.data = params[name][j]
        adam.state[p] = {"step": torch.tensor(count),
                         "exp_avg": moments["exp_avg"][name][j],
                         "exp_avg_sq": moments["exp_avg_sq"][name][j]}


def editing_step_scenes(trainer, batches, params_s, opt_state_s,
                        generator_or_draws=None, scenes=None, occ_s=None,
                        perturb: bool = True):
    """One batched multi-scene LGIE step (N scenes × M prompts; JAX
    ``editing.py:605-723``).

    ``batches``: S RayBatch (one view a scene, one image shape).
    ``params_s``: the fields' state dicts stacked on a leading scene axis
    (:func:`stack_trees`); ``opt_state_s``: their Adam states,
    ``{"step": [S], "exp_avg": {name: [S, ...]}, "exp_avg_sq": {...}}``
    (``engine/convert.py::adam_from_optax`` makes one from the JAX
    package's).  ``generator_or_draws``: a ``torch.Generator`` (default the
    trainer's), from which each scene's generator is seeded in scene order
    (the JAX ``fold_in(key, i)``), or a list of S dicts fixing a scene's
    ``bg_color``, ``t``, ``noise`` and ``vae_noise`` (the generators are
    then seeded from the trainer's).  ``scenes``: S dicts with any of
    ``params_pretrained`` (a state dict: that scene's frozen field for the
    keep_bg target), ``text_z`` / ``text_z_fg`` (:func:`prepare_scene_prompts`);
    missing entries take the trainer's.  ``occ_s``: stacked per-scene
    occupancy states, or None for ``trainer.occ_state``.

    Each scene runs the single-scene pre-pass (:func:`editing_inputs`: its
    own bg colour, pt entry keyed ``(i, img_path)``, LGIE gate drawn in
    scene order from ``trainer.np_rng``, and t), render and VAE encode
    (:func:`editing_latents`), loss and update (:func:`editing_loss`,
    ``Trainer.apply_gradients`` with the scene's Adam and count); only the
    UNet runs once for all.  There is no ``--ori_bg`` branch, as in the JAX
    step, and ``global_step`` does not move.  The device work after the
    pre-pass is the device span ``edit.step``, with a single-scene step's
    spans inside.  Returns (params_s,
    opt_state_s, losses [S], aux {``loss_sds``, ``loss_bg``: [S]}), new
    tensors; a loss is Σ latents·cotangent + loss_bg, as the JAX step
    returns it, and ``loss_sds`` is 0.5·Σ grad²."""
    opt, dev = trainer.opt, trainer.device
    if trainer.guidance is not None and trainer.guidance.family in ("xl", "flux"):
        from customnerf_torch.guidance.sds import refused
        raise refused(trainer.opt.sd_version, "multi-scene editing")
    S = len(batches)
    scenes = scenes if scenes is not None else [{}] * S
    if len(scenes) != S:
        raise ValueError(f"{len(scenes)} scene entries for {S} batches")
    H, W = int(batches[0].H), int(batches[0].W)
    if any(int(b.H) != H or int(b.W) != W for b in batches):
        raise ValueError("multi-scene editing batches must share an image shape")
    if any(b.rays_o.shape[0] != H * W for b in batches):
        raise ValueError(f"H·W = {H * W} != a batch's ray count")
    mesh = trainer.mesh
    ns = mesh.size("scene") if mesh is not None else 1
    if S % ns:
        raise ValueError(f"{S} scenes do not divide the scene axis of {ns}")
    js = mesh.index("scene") if mesh is not None else 0
    local = range(js * S // ns, (js + 1) * S // ns)

    draws = generator_or_draws if isinstance(generator_or_draws, (list, tuple)) else None
    root = (generator_or_draws if isinstance(generator_or_draws, torch.Generator)
            else trainer.generator)
    seeds = torch.randint(0, 2 ** 62, (S,), generator=root, device=root.device).tolist()
    gens = [torch.Generator(device=dev).manual_seed(int(x)) for x in seeds]
    slots = _scene_slots(trainer, len(local))
    new_params = {k: v[local.start:local.stop].clone() for k, v in params_s.items()}
    new_state = {k: {m: v[local.start:local.stop].clone() for m, v in opt_state_s[k].items()}
                 for k in ("exp_avg", "exp_avg_sq")}

    # host pre-pass, in scene order (the gate stream of every scene)
    pre = {}
    for i, batch in enumerate(batches):
        if i not in local:
            _lgie_gate(trainer, None, None)
            continue
        scene = dict(scenes[i], index=i,
                     field=_frozen_field(trainer, i, scenes[i].get("params_pretrained")),
                     occ=_occ_of(occ_s, i) if occ_s is not None else trainer.occ_state)
        with _drawing_from(trainer, gens[i]):
            pre[i], _ = editing_inputs(trainer, batch, draws[i] if draws else None,
                                       scene=scene)
    with spans.device("edit.step"):
        # per scene: render and VAE encode, graphs kept for the backward
        counts = [float(opt_state_s["step"][i]) for i in local]
        outs, latents, noises = [], [], []
        for j, i in enumerate(local):
            _bind_scene(slots[j], new_params, new_state, j, counts[j])
            with _drawing_from(trainer, gens[i]):
                out, lat, noise = editing_latents(trainer, pre[i], H, W, perturb,
                                                  draws[i] if draws else None,
                                                  field=slots[j][0])
            outs.append(out)
            latents.append(lat)
            noises.append(noise)

        # one UNet call on every local scene: batch 2·S_local
        cots = [None] * len(local)
        loss_sds = torch.zeros(len(local), device=dev)
        if opt.lambda_sd:
            with spans.device("unet"):
                cot, loss_sds = trainer.guidance.sds_grad_batch(
                    torch.cat([x.detach() for x in latents]),
                    torch.stack([pre[i]["text_emb"].reshape(
                        2, *pre[i]["text_emb"].shape[-2:]) for i in local]),
                    torch.cat([pre[i]["t"] for i in local]), torch.cat(noises))
            cots = [cot[j:j + 1] for j in range(len(local))]

        losses, loss_bgs = [], []
        for j, i in enumerate(local):
            with spans.device("loss"):
                loss, loss_bg = editing_loss(trainer, pre[i], outs[j], latents[j], cots[j],
                                             H, W)
            trainer.apply_gradients(loss, optimizer=slots[j][1], count=int(counts[j]))
            losses.append(torch.as_tensor(loss).detach().float().reshape(()))
            loss_bgs.append(loss_bg.detach() if loss_bg is not None
                            else torch.zeros((), device=dev))

        new_state["step"] = torch.tensor([c + 1.0 for c in counts])
        aux = {"loss_sds": loss_sds.detach(), "loss_bg": torch.stack(loss_bgs)}
        losses = torch.stack(losses)
    if ns > 1:
        gather = lambda x: all_gather_cat(x, mesh, "scene")     # noqa: E731
        new_params = {k: gather(v) for k, v in new_params.items()}
        new_state = {k: ({m: gather(v) for m, v in x.items()} if isinstance(x, dict)
                         else gather(x)) for k, x in new_state.items()}
        losses, aux = gather(losses), {k: gather(v) for k, v in aux.items()}
    return new_params, new_state, losses, aux
