"""Custom Diffusion concept tuning (counterpart of
``customnerf_tpu/guidance/custom_diffusion.py``).

The reference's side pipeline (``custom_diffusion/train_custom_diffusion.py``):
tune the SD UNet's cross-attention K/V projections and a ``<new1>``
modifier-token embedding on a few concept images, with prior preservation
on class images (masked MSE + prior MSE, ``:1129-1147``), then write the
artifact pair the editing stage loads (``pytorch_custom_diffusion_weights.bin``
and ``<new1>.bin``, the names ``nerf/sd.py:56-59`` reads).

The trainable set is an explicit ``cd_kv`` table (``guidance/unet.py``):
tensors keyed by the diffusers prefix of each cross-attention block, which
the frozen UNet takes in place of its own attn2 weights, plus one token row.
Tuning runs on the guidance's stack, bf16 on the card as in the JAX package
(``custom_diffusion.py:316`` builds its guidance with the default dtype);
the adapters (copied from the UNet's stored weights) and the token row stay
f32 master weights under AdamW, cast to bf16 where the UNet uses them, and
the artifacts hold their f32 bytes.
The UNet, VAE and text tower stay frozen (``requires_grad_(False)``); the row
goes into the embedding output where ``ids == token_id``, so no other row
gets a gradient or a weight decay (the JAX ``embed_with_row``).

Draws: the timesteps come from ``numpy.random.RandomState(seed)`` and the
dataset's augmentations from its own ``RandomState(seed)``, as in the JAX
package; the VAE posterior and noise draws from one ``torch.Generator``
seeded with ``seed`` (not ``jax.random``'s numbers).  ``draws=`` hands them
in instead, micro-step by micro-step, in the JAX order (VAE posterior,
noise, prior posterior, prior noise).  The resume state is the port's own
``checkpoint-{step}/state.pt``: the JAX package's ``state.pkl`` pickles JAX
tree definitions, and a directory holding only that is refused.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from customnerf_torch.guidance.text import register_token
from customnerf_torch.utils import jpeg, png, resample

# the JAX package's block name ↔ the diffusers prefix (the cd_kv key here)
_BLOCKS = (
    [(f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}")
     for i in range(3) for j in range(2)]
    + [("mid_attn_0", "mid_block.attentions.0")]
    + [(f"up_{i}_attn_{j}", f"up_blocks.{i}.attentions.{j}")
       for i in range(1, 4) for j in range(3)]
)
WEIGHTS_FILE = "pytorch_custom_diffusion_weights.bin"
RESUME_ITEM = "Custom Diffusion resume state"


def extract_cd_kv(unet, train_q_out: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """f32 copies of the cross-attention (attn2) K/V weights of ``unet`` as
    the adapter table; ``train_q_out`` adds Q and the output projection
    (weight and bias): the reference's ``--freeze_model crossattn``
    (train_custom_diffusion.py:904-946)."""
    modules = dict(unet.named_modules())
    table = {}
    for _, prefix in _BLOCKS:
        attn = modules.get(f"{prefix}.transformer_blocks.0.attn2")
        if attn is None:               # smaller configs (fewer levels/layers)
            continue
        entry = {"to_k": attn.to_k.weight, "to_v": attn.to_v.weight}
        if train_q_out:
            entry.update(to_q=attn.to_q.weight, to_out=attn.to_out[0].weight,
                         to_out_bias=attn.to_out[0].bias)
        table[prefix] = {k: v.detach().float().clone() for k, v in entry.items()}
    return table


def cd_kv_from_flax(table) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ``cd_kv`` table (flax block names, ``[in, out]`` kernels) → the
    port's (diffusers prefixes, float32 ``[out, in]`` CPU tensors)."""
    out = {}
    for ours, prefix in _BLOCKS:
        if ours not in table:
            continue
        out[prefix] = {}
        for k, v in table[ours].items():
            a = np.asarray(v, np.float32)
            out[prefix][k] = torch.tensor(np.ascontiguousarray(a if k == "to_out_bias" else a.T))
    return out


def cd_kv_to_flax(table) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`cd_kv_from_flax`, as numpy arrays."""
    out = {}
    for ours, prefix in _BLOCKS:
        if prefix not in table:
            continue
        out[ours] = {}
        for k, v in table[prefix].items():
            a = v.detach().cpu().numpy()
            out[ours][k] = np.ascontiguousarray(a if k == "to_out_bias" else a.T)
    return out


def save_cd_artifacts(out_dir: str, cd_kv, token_embeds: Dict[str, object]):
    """Write the diffusers-format artifact pair."""
    os.makedirs(out_dir, exist_ok=True)
    state = {}
    for _, prefix in _BLOCKS:
        if prefix not in cd_kv:
            continue
        entry = cd_kv[prefix]
        key = f"{prefix}.transformer_blocks.0.attn2.processor"
        for kv in ("to_k", "to_v", "to_q"):
            if kv in entry:
                state[f"{key}.{kv}_custom_diffusion.weight"] = \
                    entry[kv].detach().float().cpu().contiguous().clone()
        if "to_out" in entry:       # diffusers' to_out is a .0-indexed list
            state[f"{key}.to_out_custom_diffusion.0.weight"] = \
                entry["to_out"].detach().float().cpu().contiguous().clone()
            state[f"{key}.to_out_custom_diffusion.0.bias"] = \
                entry["to_out_bias"].detach().float().cpu().contiguous().clone()
    torch.save(state, os.path.join(out_dir, WEIGHTS_FILE))
    for tok, emb in token_embeds.items():
        row = torch.as_tensor(np.asarray(
            emb.detach().cpu() if torch.is_tensor(emb) else emb, np.float32))
        torch.save({tok: row.reshape(-1).clone()}, os.path.join(out_dir, f"{tok}.bin"))


def load_cd_artifacts(model_dir: str, text_encoder=None, device=None
                      ) -> Tuple[Optional[dict], Dict[str, np.ndarray]]:
    """Load the artifact pair: (the cd_kv table on ``device`` or None,
    {token: embedding}).  Registers each token on ``text_encoder`` when
    given."""
    cd_kv = None
    wpath = os.path.join(model_dir, WEIGHTS_FILE)
    if os.path.exists(wpath):
        sd = torch.load(wpath, map_location="cpu", weights_only=True)
        cd_kv = {}
        for _, prefix in _BLOCKS:
            key = f"{prefix}.transformer_blocks.0.attn2.processor"
            entry = {}
            for kv in ("to_k", "to_v", "to_q"):
                if f"{key}.{kv}_custom_diffusion.weight" in sd:
                    entry[kv] = sd[f"{key}.{kv}_custom_diffusion.weight"]
            if f"{key}.to_out_custom_diffusion.0.weight" in sd:
                entry["to_out"] = sd[f"{key}.to_out_custom_diffusion.0.weight"]
                entry["to_out_bias"] = sd[f"{key}.to_out_custom_diffusion.0.bias"]
            if entry:
                cd_kv[prefix] = {k: v.float().to(device) for k, v in entry.items()}
        cd_kv = cd_kv or None
    token_embeds = {}
    for tpath in sorted(glob.glob(os.path.join(glob.escape(model_dir), "<*>.bin"))):
        data = torch.load(tpath, map_location="cpu", weights_only=True)
        for name, emb in data.items():
            token_embeds[name] = emb.float().numpy().reshape(-1)
            if text_encoder is not None:
                register_token(text_encoder, name, token_embeds[name])
    return cd_kv, token_embeds


# ------------------------------------------------------------------ dataset
def _square_uint8(path: str, size: int) -> np.ndarray:
    """The centre square of an image, resized to ``size`` with cv2's
    INTER_AREA on uint8.  A JPEG is turned by its EXIF orientation first,
    as the JAX package's ``cv2.imread`` turns it (the scene loaders do not
    turn theirs, as ``csrc/dataio.cpp`` does not)."""
    img = jpeg.read_oriented(path) if jpeg.is_jpeg_path(path) else png.read_rgb(path)
    h, w = img.shape[:2]
    s = min(h, w)
    img = img[(h - s) // 2:(h + s) // 2, (w - s) // 2:(w + s) // 2]
    return resample.resize_cv_area(img, size, size)


def _load_image_square(path: str, size: int = 512) -> np.ndarray:
    """:func:`_square_uint8` as float32 [size, size, 3] in [-1, 1]."""
    return _square_uint8(path, size).astype(np.float32) / 127.5 - 1.0


def _image_files(d):
    return sorted(p for p in glob.glob(os.path.join(d, "*"))
                  if p.lower().endswith((".jpg", ".jpeg", ".png")))


class ConceptDataset:
    """Instance and class images with the reference's random-scale
    augmentation (scale < 0.6 → "a far away photo", > 1.2 → "zoomed in
    photo"; valid-region masks at latent resolution,
    train_custom_diffusion.py:165-303), drawn from ``RandomState(seed)``
    in the JAX order: ``choice``, ``rand`` for the flip, ``uniform``.  Each
    file is decoded and squared once (uint8, ``size``² × 3 bytes kept): the
    port's decoders run in Python, and a full-width step spent most of its
    time re-reading the same images."""

    def __init__(self, instance_dir: str, instance_prompt: str,
                 class_dir: Optional[str] = None, class_prompt: str = "",
                 size: int = 512, seed: int = 0, hflip: bool = True):
        self.instance = _image_files(instance_dir)
        if not self.instance:
            raise ValueError(f"no instance images in {instance_dir}")
        self.cls = _image_files(class_dir) if class_dir else []
        self.instance_prompt = instance_prompt
        self.class_prompt = class_prompt
        self.size = size
        self.hflip = hflip
        self.rng = np.random.RandomState(seed)
        self._squares = {}

    def _image(self, path: str) -> np.ndarray:
        if path not in self._squares:
            self._squares[path] = _square_uint8(path, self.size)
        return self._squares[path].astype(np.float32) / 127.5 - 1.0

    def sample_instance(self):
        img = self._image(self.rng.choice(self.instance))
        if self.hflip and self.rng.rand() < 0.5:
            img = img[:, ::-1].copy()
        scale = self.rng.uniform(0.4, 1.4)
        prompt, size = self.instance_prompt, self.size
        canvas = np.zeros((size, size, 3), np.float32)
        mask = np.zeros((size // 8, size // 8, 1), np.float32)
        new = max(32, int(size * min(scale, 1.0)))
        scaled = resample.resize_cv_area(img, new, new)
        off = (size - new) // 2
        canvas[off:off + new, off:off + new] = scaled
        moff, mnew = off // 8, new // 8
        mask[moff:moff + mnew, moff:moff + mnew] = 1.0
        if scale < 0.6:
            prompt = f"a far away photo of {self.instance_prompt}"
        elif scale > 1.2:
            prompt = f"zoomed in photo of a {self.instance_prompt}"
            canvas = img
            mask[:] = 1.0
        return canvas, mask, prompt

    def sample_class(self):
        img = self._image(self.rng.choice(self.cls))
        mask = np.ones((self.size // 8, self.size // 8, 1), np.float32)
        return img, mask, self.class_prompt


# -------------------------------------------------------- state save/resume
def _rng_state(rs: np.random.RandomState):
    name, keys, pos, has_gauss, gauss = rs.get_state()
    return [name, keys.tolist(), int(pos), int(has_gauss), float(gauss)]


def _set_rng_state(rs: np.random.RandomState, st):
    name, keys, pos, has_gauss, gauss = st
    rs.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss, gauss))


def _save_cd_state(output_dir: str, step: int, trainable, optimizer, streams) -> str:
    """``checkpoint-{step}/state.pt``: the step, the adapters and token row,
    the AdamW state and the draw streams (the dataset's and the timesteps'
    RandomState, the generator's state), so that a resumed run continues
    the straight run's draws."""
    d = os.path.join(output_dir, f"checkpoint-{step}")
    os.makedirs(d, exist_ok=True)
    torch.save({"step": step,
                "cd_kv": {p: {k: v.detach().cpu() for k, v in e.items()}
                          for p, e in trainable["cd_kv"].items()},
                "tok_row": trainable["tok_row"].detach().cpu(),
                "optimizer": optimizer.state_dict(),
                "data_rng": _rng_state(streams["data"]),
                "t_rng": _rng_state(streams["t"]),
                "generator": streams["generator"].get_state()},
               os.path.join(d, "state.pt"))
    return d


def _load_cd_state(path: str) -> dict:
    f = os.path.join(path, "state.pt")
    if not os.path.exists(f):
        if os.path.exists(os.path.join(path, "state.pkl")):
            raise ValueError(
                f"{path} holds the JAX package's resume state (state.pkl, pickled "
                f"JAX tree definitions), which the port cannot read; the port "
                f"resumes from its own state.pt (ROADMAP.md, '{RESUME_ITEM}')")
        raise ValueError(f"{path}: no state.pt")
    return torch.load(f, map_location="cpu", weights_only=True)


def _latest_cd_checkpoint(output_dir: str) -> Optional[str]:
    dirs = [d for d in glob.glob(os.path.join(output_dir, "checkpoint-*"))
            if os.path.isdir(d)]
    return max(dirs, key=lambda d: int(d.rsplit("-", 1)[1])) if dirs else None


# ----------------------------------------------------------------- trainer
def _nchw(a, device):
    return torch.from_numpy(np.ascontiguousarray(np.stack(a).transpose(0, 3, 1, 2))).to(device)


def train_custom_diffusion(
    opt,
    instance_dir: str,
    instance_prompt: str,
    output_dir: str,
    class_dir: Optional[str] = None,
    class_prompt: str = "",
    modifier_token: str = "<new1>",
    initializer_token: str = "ktn",
    steps: int = 250,
    lr: float = 1e-5,
    prior_loss_weight: float = 1.0,
    image_size: int = 512,
    batch_size: int = 2,
    grad_accum: int = 1,
    freeze_model: str = "crossattn_kv",
    checkpointing_steps: int = 250,
    resume_from_checkpoint: Optional[str] = None,
    validation_prompt: Optional[str] = None,
    validation_steps: int = 50,
    num_validation_images: int = 2,
    guidance=None,
    device=None,
    draws: Optional[Callable[[int], dict]] = None,
    log=print,
    on_step: Optional[Callable[[int, float], None]] = None,
):
    """Tune the adapters and the modifier-token row; save the artifacts
    into ``output_dir`` and return it.

    The JAX signature, plus: ``guidance`` (a built ``StableDiffusionGuidance``;
    one is built from ``opt`` on ``device`` otherwise), ``draws`` (micro-step
    index → {"vae", "noise"[, "vae2", "noise2"]} NCHW tensors, the index
    counted from the start of a straight run), ``log`` and ``on_step``
    (called with the optimizer step and its last micro-step's loss).

      * ``batch_size`` instance images a micro-step, each paired with a class
        image under prior preservation (bs 2 in tuning.sh:8-24);
      * ``grad_accum`` micro-steps an update, whose gradient is their mean
        (``optax.MultiSteps``);
      * ``freeze_model``: "crossattn_kv" trains K/V, "crossattn" also Q and
        the output projection (ref :904-946);
      * ``checkpointing_steps`` / ``resume_from_checkpoint`` ("latest" or a
        checkpoint-N dir);
      * ``validation_prompt``: a DDIM sample grid every ``validation_steps``.
    """
    from customnerf_torch.guidance.sds import StableDiffusionGuidance, refused, sd_family

    assert freeze_model in ("crossattn_kv", "crossattn"), freeze_model
    if sd_family(opt.sd_version) in ("xl", "flux"):
        raise refused(opt.sd_version, "Custom Diffusion tuning")
    if guidance is None:
        guidance = StableDiffusionGuidance(opt, device=device)
    dev = guidance.device
    te = guidance.text_encoder
    model = te.model.text_model

    # register <new1>, initialised from the initializer token's row
    init_id = int(te.tokenize([initializer_token])[0][1])   # the token after BOS
    table = model.embeddings.token_embedding.weight
    token_id = register_token(te, modifier_token,
                              table[min(init_id, table.shape[0] - 1)].detach().cpu().numpy())
    table = model.embeddings.token_embedding.weight

    cd_kv = extract_cd_kv(guidance.unet, train_q_out=(freeze_model == "crossattn"))
    tok_row = table[token_id].detach().clone()
    trainable = {"cd_kv": cd_kv, "tok_row": tok_row}
    params = [v for e in cd_kv.values() for v in e.values()] + [tok_row]
    for p in params:
        p.requires_grad_(True)
    optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-2)

    ds = ConceptDataset(instance_dir, f"photo of a {modifier_token} {instance_prompt}",
                        class_dir, class_prompt, size=image_size, seed=opt.seed)
    use_prior = bool(ds.cls)
    scheduler = guidance.scheduler
    T = scheduler.num_train_timesteps
    streams = {"data": ds.rng, "t": np.random.RandomState(opt.seed),
               "generator": torch.Generator(device=dev).manual_seed(int(opt.seed))}

    start_step = 0
    if resume_from_checkpoint:
        path = (resume_from_checkpoint if resume_from_checkpoint != "latest"
                else _latest_cd_checkpoint(output_dir))
        if path and os.path.isdir(str(path)):
            st = _load_cd_state(str(path))
            start_step = int(st["step"])
            with torch.no_grad():
                for p, e in cd_kv.items():
                    for k, v in e.items():
                        v.copy_(st["cd_kv"][p][k])
                tok_row.copy_(st["tok_row"])
            optimizer.load_state_dict(st["optimizer"])
            _set_rng_state(streams["data"], st["data_rng"])
            _set_rng_state(streams["t"], st["t_rng"])
            streams["generator"].set_state(st["generator"])
            log(f"[cd-tune] resumed from {path} at step {start_step}")
        else:
            log(f"[cd-tune] checkpoint '{resume_from_checkpoint}' not found; "
                f"starting fresh")

    def gaussian(shape):
        return torch.randn(shape, generator=streams["generator"], device=dev)

    def latents_of(imgs, noise):
        x = _nchw([(im + 1) / 2 for im in imgs], dev)
        with torch.no_grad():
            return guidance.encode_imgs(x, noise=noise)

    lat_shape = (batch_size, 4, image_size // 8, image_size // 8)
    micro_per_step = max(grad_accum, 1)
    micro = start_step * micro_per_step
    step_i = start_step
    loss = torch.zeros(())
    while step_i < steps:
        optimizer.zero_grad(set_to_none=True)
        for _ in range(micro_per_step):
            d = draws(micro) if draws is not None else {}
            micro += 1
            vae_noise = d["vae"] if "vae" in d else gaussian(lat_shape)
            noise = d["noise"] if "noise" in d else gaussian(lat_shape)
            ts = streams["t"].randint(0, T, size=2 * batch_size)
            imgs, masks, prompts = zip(*(ds.sample_instance() for _ in range(batch_size)))
            latents = latents_of(imgs, vae_noise.to(dev))
            ids = torch.from_numpy(te.tokenize(list(prompts))).long().to(dev)
            t = torch.from_numpy(ts[:batch_size]).long().to(dev)
            mask = _nchw(masks, dev)
            ctx = model(ids, row=tok_row, row_id=token_id)[0]
            noisy = scheduler.add_noise(latents, noise.to(dev), t)
            pred = guidance.unet(noisy, t, ctx, cd_kv=cd_kv)
            inst = (((pred - noise.to(dev)) ** 2) * mask).sum() / (
                mask.sum() * latents.shape[1] + 1e-8)
            # the two losses' backwards run one after the other: the same
            # gradient, with one UNet graph alive at a time
            (inst / micro_per_step).backward()
            loss = inst.detach()
            del pred, ctx, noisy
            if use_prior:
                vae2 = d["vae2"] if "vae2" in d else gaussian(lat_shape)
                imgs2, _, prompts2 = zip(*(ds.sample_class() for _ in range(batch_size)))
                latents_pr = latents_of(imgs2, vae2.to(dev))
                noise2 = (d["noise2"] if "noise2" in d else gaussian(lat_shape)).to(dev)
                ctx_pr = te.encode(list(prompts2))
                t_pr = torch.from_numpy(ts[batch_size:]).long().to(dev)
                pred2 = guidance.unet(scheduler.add_noise(latents_pr, noise2, t_pr),
                                      t_pr, ctx_pr, cd_kv=cd_kv)
                prior = prior_loss_weight * ((pred2 - noise2) ** 2).mean()
                (prior / micro_per_step).backward()
                loss = loss + prior.detach()
                del pred2
        optimizer.step()
        step_i += 1
        loss_value = float(loss)
        if on_step is not None:
            on_step(step_i, loss_value)
        if (step_i - start_step) % 50 == 1 or step_i % 50 == 0:
            log(f"[cd-tune] step {step_i} loss {loss_value:.4f}")
        if checkpointing_steps and step_i % checkpointing_steps == 0 and step_i < steps:
            _save_cd_state(output_dir, step_i, trainable, optimizer, streams)
        if validation_prompt and step_i % validation_steps == 0:
            _cd_validation(guidance, trainable, token_id, validation_prompt,
                           num_validation_images, output_dir, step_i, image_size, log)

    for p in params:
        p.requires_grad_(False)
    save_cd_artifacts(output_dir, cd_kv, {modifier_token: tok_row})
    log(f"[cd-tune] saved artifacts to {output_dir}")
    return output_dir


@torch.no_grad()
def _cd_validation(guidance, trainable, token_id, prompt: str, n_images: int,
                   output_dir: str, step: int, image_size: int, log=print):
    """DDIM samples with the current adapters and token row, as PNGs
    (reference train_custom_diffusion.py:1215-1329 log_validation)."""
    from customnerf_torch.guidance.sampler import ddim_sample

    table = guidance.text_encoder.model.text_model.embeddings.token_embedding.weight
    saved_row, saved_kv = table[token_id].clone(), getattr(guidance, "cd_kv", None)
    table[token_id] = trainable["tok_row"]
    guidance.cd_kv = trainable["cd_kv"]
    try:
        vd = os.path.join(output_dir, "validation")
        os.makedirs(vd, exist_ok=True)
        for i in range(n_images):
            gen = torch.Generator(device=guidance.device).manual_seed(step + i)
            img = ddim_sample(guidance, prompt, generator=gen, num_steps=25,
                              height=image_size, width=image_size)
            png.write(os.path.join(vd, f"step{step:05d}_{i}.png"),
                      (img.cpu().numpy() * 255).astype(np.uint8))
        log(f"[cd-tune] wrote {n_images} validation samples at step {step}")
    finally:
        table[token_id] = saved_row
        guidance.cd_kv = saved_kv


# --------------------------------------------------------------- merging
def merge_concepts(concept_dirs, base_kv, reg_embeddings, concept_embeddings,
                   steps: int = 200, lr: float = 1e-2):
    """Optimisation-based multi-concept K/V merge (the JAX package's working
    rebuild of the reference's ``custom_diffusion/composenW.py``): one table
    W that matches each concept's table on that concept's text embeddings
    and stays near the base table on regularisation embeddings,

        min_W  Σ_i 10·mean((c_i (W − W_i))²) + mean((C_reg (W − W_base))²)

    over every block's ``to_k`` and ``to_v`` (torch ``[out, in]`` here, so
    the products are ``c @ Wᵀ``), by Adam(lr) — optax's ``adam`` defaults
    are torch's.  Returns the merged table."""
    tables = []
    for d in concept_dirs:
        kv, _ = load_cd_artifacts(d)
        if kv is None:
            raise ValueError(f"no adapter weights in {d}")
        tables.append(kv)
    reg = torch.as_tensor(np.asarray(reg_embeddings, np.float32))
    cons = [torch.as_tensor(np.asarray(c, np.float32)) for c in concept_embeddings]
    base = {n: {k: torch.as_tensor(v).detach().float().cpu() for k, v in e.items()}
            for n, e in base_kv.items()}
    merged = {n: {k: v.clone().requires_grad_(True) for k, v in e.items()}
              for n, e in base.items()}
    params = [v for e in merged.values() for v in e.values()]
    optimizer = torch.optim.Adam(params, lr=lr)
    for _ in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        for name in base:
            for kv_name in ("to_k", "to_v"):
                w = merged[name][kv_name]
                loss = loss + ((reg @ (w - base[name][kv_name]).T) ** 2).mean()
                for tbl, c in zip(tables, cons):
                    if name in tbl and kv_name in tbl[name]:
                        loss = loss + ((c @ (w - tbl[name][kv_name]).T) ** 2).mean() * 10.0
        loss.backward()
        optimizer.step()
    return {n: {k: v.detach() for k, v in e.items()} for n, e in merged.items()}
