"""LGIE editing: Local-Global Iterative Editing with SDS guidance
(counterpart of ``customnerf_tpu/engine/editing.py``, single scene, one step
a call).

One step renders the full frame once with the graph, resizes the chosen
image (full, or foreground under the local branch) to 512² bilinear,
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

The bg colour, t and both noises come from the trainer's ``torch.Generator``
(not ``jax.random``'s streams); ``draws`` hands them in for tests.

Dtypes along the step, as in the JAX package: the render and the resized
image are f32; the VAE encodes in the guidance's dtype (bf16 on the card)
and gives f32 latents; the UNet casts them to its dtype and gives f32 ε;
the SDS cotangent, the surrogate loss and the gradient into the NeRF are
f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from customnerf_torch.guidance.clip_view import VIEW_NAMES

# side of the square image the VAE encodes (reference sd.py:99)
RESIZE = 512


def prepare_text_embeddings(trainer):
    """Embed text / text_fg / text_norm / text_fg_norm / text_bg, per view
    under --clip_view (utils_init_nerf.py:310-351)."""
    opt, guidance = trainer.opt, trainer.guidance

    def embed(text):
        if opt.clip_view:
            return [guidance.get_text_embeds([f"{text}, {d} view"], [opt.negative])
                    for d in VIEW_NAMES]
        return guidance.get_text_embeds([text], [opt.negative])

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


def _get_pt(trainer, batch, bg_color):
    """The frozen-model render of ``batch``'s image, computed once per
    img_path (utils_init_nerf.py:243-265)."""
    if batch.img_path in trainer.pt_dict:
        return trainer.pt_dict[batch.img_path]
    out = trainer.render_image(batch.rays_o, batch.rays_d, perturb=True,
                               bg_color=bg_color, field=trainer.field_pretrained)
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
    trainer.pt_dict[batch.img_path] = entry
    return entry


def _select_text(trainer, match_probs):
    """--clip_view: the argmax view's prompts (utils_init_nerf.py:267-280)."""
    if trainer.opt.clip_view and match_probs is not None:
        sel = int(match_probs.argmax())
        return trainer.text_z[sel], trainer.text_z_fg[sel]
    return trainer.text_z, trainer.text_z_fg


def _bg_color(trainer):
    opt, dev = trainer.opt, trainer.device
    if opt.random_bg_c:
        return torch.rand(3, generator=trainer.generator, device=dev)
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


def editing_step(trainer, batch, perturb: bool = True, draws=None, mark=None):
    """One LGIE editing step.  Returns (loss, aux, render stats): ``aux``
    holds ``loss_sds`` (0.5·Σ grad², the reference's value) and ``loss_bg``,
    ``loss`` their sum.  ``draws`` may fix ``bg_color``, ``t``, ``noise``
    (the SDS ε) and ``vae_noise`` (the posterior sample's ε); ``mark(name)``
    is called at the stage boundaries ``pt`` (the cached frozen render and
    the draws done), ``latents``, ``unet`` and ``update``.  The stats add
    the LGIE branch (``local``) and ``t``."""
    opt, guidance = trainer.opt, trainer.guidance
    if guidance is None:
        raise RuntimeError("editing needs the SD guidance (--lambda_sd > 0)")
    draws = draws or {}
    mark = mark or (lambda _: None)
    if not hasattr(trainer, "text_z"):
        prepare_text_embeddings(trainer)

    bg_color = draws["bg_color"] if "bg_color" in draws else _bg_color(trainer)
    pt = _get_pt(trainer, batch, bg_color)
    text_z, text_z_fg = _select_text(trainer, pt["match_probs"])
    use_fg, text_emb, t_ratio = _lgie_gate(trainer, text_z, text_z_fg)
    t = draws["t"] if "t" in draws else guidance.sample_timestep(
        trainer.generator, trainer.global_step, t_ratio)
    mark("pt")

    H, W = batch.H, batch.W
    n = H * W
    out = trainer.render(batch.rays_o, batch.rays_d, train=True,
                         perturb=perturb, bg_color=bg_color)
    pred_rgb_bg = out["bg"]["image"][:n].reshape(H, W, 3)
    pred_mask = out["render_mask"][:n].reshape(H, W, -1)
    loss = 0.0
    aux = {}
    if opt.lambda_sd:
        img = out["fg"]["image"] if use_fg else out["image"]
        img = img[:n].reshape(1, H, W, 3).permute(0, 3, 1, 2)
        img = F.interpolate(img, size=(RESIZE, RESIZE), mode="bilinear",
                            align_corners=False, antialias=True)
        latents = guidance.encode_imgs(img, generator=trainer.generator,
                                       noise=draws.get("vae_noise"))
        mark("latents")
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(latents.shape, generator=trainer.generator,
                                device=latents.device)
        cotangent, aux["loss_sds"] = guidance.sds_grad(latents.detach(),
                                                       text_emb, t, noise)
        mark("unet")
        loss = (latents * cotangent).sum()
    if opt.keep_bg:
        target_bg = pt["pt_rgb_bg"]
        if opt.ori_bg:
            non_edit = (pt["pt_mask"].mean(-1, keepdim=True)
                        + pred_mask.mean(-1, keepdim=True)) < 0.5
            target_bg = torch.where(non_edit, batch.rgbs[:n].reshape(H, W, 3),
                                    target_bg)
        aux["loss_bg"] = opt.keep_bg * (target_bg - pred_rgb_bg).abs().mean()
        loss = loss + aux["loss_bg"]
    trainer.apply_gradients(loss)
    mark("update")
    aux = {k: v.detach() for k, v in aux.items()}
    return sum(aux.values()), aux, dict(out["stats"], local=use_fg, t=t)
