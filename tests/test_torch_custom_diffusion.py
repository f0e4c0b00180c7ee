"""The port's Custom Diffusion path against the JAX package's, on the CPU
at reduced width (the tiny UNet / VAE / CLIP text configs of
``tests/test_torch_guidance.py``, a VAE with three downsamples so 64×64
images give 8×8 latents): the concept images (``_load_image_square``,
``ConceptDataset``), ε under ``cd_kv``, the artifact pair both ways, one
tuning step with the JAX draws handed over, resume, merging, DDIM, class
images and the weights drill.

Weights are the JAX modules' random leaves carried flax → port by
``engine/convert.py::state_from_flax``; the JAX adapter tables cross by
``custom_diffusion.cd_kv_from_flax`` / ``cd_kv_to_flax``.  Tolerances: ε and
DDIM images to 1e-4 of the largest entry (f32 through tens of layers summed
in other orders, the rule of ``test_unet_eps_matches_jax``); the tuning
loss to 1e-5 relative and the adapters and token row after AdamW to 1e-5 of
their largest entry; the merge to 1e-5; uint8 images to 1 level and float
images to 1e-6; the drill's parameter counts exactly and checksums to 1e-6
relative.
"""

import copy
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.config import Config as JConfig
from customnerf_tpu.guidance import custom_diffusion as jcd
from customnerf_tpu.guidance import scheduler as jsched
from customnerf_tpu.guidance import text as jtext
from customnerf_tpu.guidance.sds import StableDiffusionGuidance as JGuidance
from customnerf_tpu.guidance.unet import UNet2DCondition as JUNet, UNetConfig as JUNetConfig
from customnerf_tpu.guidance.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from customnerf_torch.config import Config, parse_args
from customnerf_torch.engine.convert import state_from_flax
from customnerf_torch.guidance import custom_diffusion as cd
from customnerf_torch.guidance import text as ttext
from customnerf_torch.guidance.sds import StableDiffusionGuidance
from customnerf_torch.guidance.unet import UNetConfig
from customnerf_torch.guidance.vae import VAEConfig
from customnerf_torch.utils.jpeg import write_jpeg

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guidance import UNET_TINY, close, nchw, one_thread, random_params  # noqa: E402,F401

cv2 = pytest.importorskip("cv2")

CTX = UNET_TINY["cross_attention_dim"]
VAE_8X = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TEXT = dict(hidden_size=CTX, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4)
SIZE = 64


@dataclasses.dataclass(frozen=True)
class Stack:
    """A reduced-width SD stack for both packages: the UNet's config, the
    text tower's (with its activation) and whether the diffusers files store
    ``proj_in``/``proj_out`` as linear layers (SD 2.x)."""
    unet: tuple = tuple(dict(UNET_TINY, attention_head_dim=4).items())
    text: tuple = tuple(dict(TEXT, hidden_act="quick_gelu").items())
    linear_proj: bool = False

    @property
    def unet_kw(self):
        return dict(self.unet)

    @property
    def text_kw(self):
        return dict(self.text)

    @property
    def ctx(self):
        return self.unet_kw["cross_attention_dim"]


SD15 = Stack()


@functools.lru_cache(maxsize=None)
def _params(stack=SD15):
    """The JAX modules' random leaves (numpy), made once a stack."""
    from transformers import CLIPTextConfig as HFTextConfig, FlaxCLIPTextModel
    ju = JUNet(JUNetConfig(**stack.unet_kw))
    jv = JVAE(JVAEConfig(**VAE_8X))
    up = random_params(jax.eval_shape(
        ju.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, stack.ctx))), 11)
    vp = random_params(jax.eval_shape(
        lambda k: jv.init({"params": k}, jnp.zeros((1, SIZE, SIZE, 3)), k),
        jax.random.PRNGKey(0)), 12)
    hf = HFTextConfig(vocab_size=ttext.VOCAB, max_position_embeddings=77, **stack.text_kw)
    tp = random_params(jax.eval_shape(lambda k: FlaxCLIPTextModel(hf, _do_init=False)
                                      .init_weights(k, (1, 77)), jax.random.PRNGKey(0)), 13)
    return up, vp, tp, hf


def make_pair(seed=0, stack=SD15):
    """(JAX guidance, port guidance) on the same tiny weights, each with a
    fresh text encoder (tuning registers tokens on it)."""
    from transformers import FlaxCLIPTextModel
    up, vp, tp, hf = _params(stack)
    jg = JGuidance.__new__(JGuidance)
    jg.opt = JConfig(data_type="synthetic", seed=seed)
    jg.unet = JUNet(JUNetConfig(**stack.unet_kw))
    jg.vae = JVAE(JVAEConfig(**VAE_8X))
    jg.unet_params = jax.tree_util.tree_map(jnp.asarray, up)
    jg.vae_params = jax.tree_util.tree_map(jnp.asarray, vp)
    te = jtext.TextEncoder.__new__(jtext.TextEncoder)
    te.sd_version, te.tokenizer, te.hidden_size = "1.5", jtext.HashTokenizer(), stack.ctx
    te.model = FlaxCLIPTextModel(copy.deepcopy(hf), _do_init=False)
    te.params = jax.tree_util.tree_map(jnp.asarray, tp)
    jg.text_encoder, jg.cd_kv, jg.system = te, None, None
    jg.scheduler = jsched.DDPMSchedule()
    jg.num_train_timesteps, jg.min_step, jg.max_step = 1000, 20, 980
    jg.alphas = jg.scheduler.alphas_cumprod

    opt = Config(data_type="synthetic", seed=seed)
    text = ttext.TextEncoder(model=ttext.CLIPTextModel(ttext.CLIPTextConfig(
        **stack.text_kw)))
    text.model.load_state_dict(state_from_flax(tp))
    tg = StableDiffusionGuidance(opt, device="cpu", text_encoder=text,
                                 unet_cfg=UNetConfig(**stack.unet_kw),
                                 vae_cfg=VAEConfig(**VAE_8X))
    tg.unet.load_state_dict(state_from_flax(up))
    tg.vae.load_state_dict(state_from_flax(vp))
    return jg, tg


def random_table(seed, q_out=False, stack=SD15):
    """A JAX-layout adapter table ([in, out] kernels) for the tiny UNet."""
    rs = np.random.RandomState(seed)
    up = _params(stack)[0]["params"]
    table = {}
    for ours, _ in jcd._BLOCKS:
        if ours not in up:
            continue
        a = up[ours]["transformer_blocks_0"]["attn2"]
        e = {k: a[k]["kernel"] + 0.1 * rs.randn(*a[k]["kernel"].shape).astype(np.float32)
             for k in ("to_k", "to_v")}
        if q_out:
            e["to_q"] = a["to_q"]["kernel"] + 0.1 * rs.randn(*a["to_q"]["kernel"].shape)
            e["to_out"] = a["to_out_0"]["kernel"] * 1.1
            e["to_out_bias"] = a["to_out_0"]["bias"] + 0.05
        table[ours] = {k: np.asarray(v, np.float32) for k, v in e.items()}
    return table


@functools.lru_cache(maxsize=None)
def _japply(stack=SD15):
    """One jitted UNet apply a stack for the tests of this file."""
    unet = JUNet(JUNetConfig(**stack.unet_kw))
    return jax.jit(lambda p, x, t, c, kv: unet.apply(p, x, t, c, cd_kv=kv))


def _eps_pair(jg, tg, jtable, ttable, seed=3, stack=SD15):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 7, stack.ctx).astype(np.float32)
    t = np.array([37, 612])
    want = _japply(stack)(jg.unet_params, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                     jnp.asarray(ctx), jtable)
    with torch.no_grad():
        got = tg.unet(nchw(x), torch.tensor(t), torch.tensor(ctx), cd_kv=ttable)
    return got.numpy(), np.asarray(want).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("q_out", [False, True], ids=["kv", "kv_q_out"])
def test_eps_under_cd_kv_matches_jax(q_out):
    jg, tg = make_pair()
    jtable = random_table(5, q_out)
    ttable = cd.cd_kv_from_flax(jtable)
    assert set(ttable) == {"down_blocks.0.attentions.0", "down_blocks.0.attentions.1",
                           "mid_block.attentions.0", "up_blocks.1.attentions.0",
                           "up_blocks.1.attentions.1", "up_blocks.1.attentions.2"}
    assert ttable["mid_block.attentions.0"]["to_k"].shape == (64, CTX)   # [out, in]
    got, want = _eps_pair(jg, tg, jtable, ttable)
    close(got, want)
    plain, _ = _eps_pair(jg, tg, None, None)
    assert np.abs(got - plain).max() > 1e-3 * np.abs(plain).max()   # the table acts
    back = cd.cd_kv_to_flax(ttable)
    for k in jtable:
        for n in jtable[k]:
            np.testing.assert_array_equal(back[k][n], jtable[k][n])
    # extract_cd_kv reads the UNet's own weights: an identity override
    own = cd.extract_cd_kv(tg.unet, train_q_out=q_out)
    same, _ = _eps_pair(jg, tg, None, own)
    np.testing.assert_array_equal(same, plain)


def test_artifacts_load_both_ways(tmp_path):
    """JAX ``save_cd_artifacts`` → port ``load_cd_artifacts`` and the port's
    files → the JAX loader: the same ε, ``<new1>`` at id 49408 on both
    sides, its row in the token table."""
    check_artifacts_both_ways(tmp_path, SD15)


def check_artifacts_both_ways(tmp_path, stack):
    jg, tg = make_pair(stack=stack)
    jtable = random_table(7, q_out=True, stack=stack)
    row = np.random.RandomState(8).randn(stack.ctx).astype(np.float32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcd.save_cd_artifacts(jdir, {k: {n: jnp.asarray(v) for n, v in e.items()}
                                 for k, e in jtable.items()}, {"<new1>": row})
    ttable, toks = cd.load_cd_artifacts(jdir, tg.text_encoder)
    np.testing.assert_array_equal(toks["<new1>"], row)
    assert tg.text_encoder.tokenizer.add_token("<new1>") == 49408
    table = tg.text_encoder.model.text_model.embeddings.token_embedding.weight
    assert table.shape[0] == 49409
    np.testing.assert_array_equal(table[49408].numpy(), row)
    got, want = _eps_pair(jg, tg, jtable, ttable, stack=stack)
    close(got, want)

    cd.save_cd_artifacts(tdir, ttable, {"<new1>": torch.tensor(row)})
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "<new1>.bin", "pytorch_custom_diffusion_weights.bin"]
    kv, jtoks = jcd.load_cd_artifacts(tdir, jg.text_encoder)
    np.testing.assert_array_equal(jtoks["<new1>"], row)
    assert jg.text_encoder.tokenizer.add_token("<new1>") == 49408
    got2, want2 = _eps_pair(jg, tg, kv, ttable, stack=stack)
    close(got2, want2)
    assert ttable["mid_block.attentions.0"]["to_k"].shape[1] == stack.ctx
    # the grown token table crosses flax → port like the rest of the tower
    grown = ttext.CLIPTextModel(ttext.CLIPTextConfig(vocab_size=49409, **stack.text_kw))
    grown.load_state_dict(state_from_flax(jax.tree_util.tree_map(
        np.asarray, jg.text_encoder.params)))
    np.testing.assert_array_equal(
        grown.text_model.embeddings.token_embedding.weight[49408].detach().numpy(), row)
    ids = jg.text_encoder.tokenize(["a <new1> bear"])
    np.testing.assert_array_equal(tg.text_encoder.tokenize(["a <new1> bear"]), ids)
    want_ctx = np.asarray(jg.text_encoder.encode(["a <new1> bear"]))
    got_ctx = tg.text_encoder.encode(["a <new1> bear"]).numpy()
    close(got_ctx, want_ctx, 1e-5)


def _concept_images(d, sizes, ext=".png", seed=0):
    """Smooth gradients with a little noise (the decoder's cost is its
    Huffman symbols)."""
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 0.4 + i * 40), (yy * 0.3) + 20,
                        ((xx + yy) * 0.2) + 60], -1).astype(np.float64)
        img = np.clip(img + rs.randn(h, w, 3) * 2, 0, 255).astype(np.uint8)
        path = os.path.join(d, f"c{i}{ext}")
        if ext == ".png":
            cv2.imwrite(path, img[..., ::-1])
        else:
            write_jpeg(path, img)
    return d


@pytest.mark.parametrize("src", [(40, 52), (700, 600)], ids=["enlarge", "shrink"])
def test_load_image_square_matches_jax(tmp_path, src):
    d = _concept_images(str(tmp_path), [src])
    path = os.path.join(d, "c0.png")
    want = jcd._load_image_square(path, 512)
    got = cd._load_image_square(path, 512)
    assert got.shape == want.shape == (512, 512, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 127.5 + 1e-6)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_concept_read_applies_exif_orientation_as_jax(tmp_path, orientation):
    """A concept JPEG carrying an EXIF orientation reads as the JAX
    package's ``cv2.imread`` reads it (turned, then squared); the scene
    loaders' rule is ``tests/test_torch_jpeg.py``'s
    ``test_exif_orientation_is_not_applied``."""
    from PIL import Image
    from customnerf_torch.utils import jpeg

    rs = np.random.RandomState(orientation)
    yy, xx = np.mgrid[0:48, 0:80]
    img = np.stack([xx * 3 % 256, yy * 5 % 256, (xx + 2 * yy) % 256], -1)
    img = np.clip(img + rs.randn(48, 80, 3) * 4, 0, 255).astype(np.uint8)
    img[:12, :20] = (255, 0, 0)                       # a corner that shows the turn
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / f"o{orientation}.jpg")
    Image.fromarray(img).save(path, quality=95, exif=exif.tobytes())
    with open(path, "rb") as fh:
        assert jpeg.exif_orientation(fh.read()) == orientation
    shown = cv2.imread(path)[..., ::-1]
    np.testing.assert_array_equal(jpeg.read_oriented(path), shown)
    for size in (32, 512):
        want = jcd._load_image_square(path, size)
        got = cd._load_image_square(path, size)
        assert got.shape == want.shape == (size, size, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 127.5 + 1e-6)


def test_concept_dataset_matches_jax(tmp_path):
    """20 draws of one seed: canvas (1 level of the uint8 resize, then the
    float resize), mask and prompt, instance and class, sources smaller and
    larger than 512 (JPEG and PNG)."""
    inst = _concept_images(str(tmp_path / "inst"), [(300, 280), (600, 640)], ".jpg")
    _concept_images(inst, [(96, 128)], ".png", seed=1)
    cls = _concept_images(str(tmp_path / "cls"), [(520, 530)], ".png", seed=2)
    args = (inst, "photo of a <new1> bear", cls, "bear")
    j, t = jcd.ConceptDataset(*args, size=512, seed=3), cd.ConceptDataset(*args, size=512, seed=3)
    assert t.instance == j.instance and t.cls == j.cls
    prompts = set()
    for _ in range(20):
        (jc, jm, jp), (tc, tm, tp) = j.sample_instance(), t.sample_instance()
        assert tp == jp
        prompts.add(tp)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1.0 / 127.5 + 1e-6)
    assert len(prompts) == 3                       # far away, plain, zoomed in
    (jc, jm, jp), (tc, tm, tp) = j.sample_class(), t.sample_class()
    assert tp == jp == "bear"
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1.0 / 127.5 + 1e-6)


def _jax_draws(seed, batch, prior):
    """The JAX trainer's Gaussians, micro-step by micro-step: key → (key,
    k_vae, k_noise, k_vae2); the noise of the prior loss from
    fold_in(k_noise, 1)."""
    shape = (batch, SIZE // 8, SIZE // 8, 4)

    def draws(i):
        key = jax.random.PRNGKey(seed)
        for _ in range(i + 1):
            key, k_vae, k_noise, k_vae2 = jax.random.split(key, 4)
        out = {"vae": nchw(jax.random.normal(k_vae, shape)),
               "noise": nchw(jax.random.normal(k_noise, shape))}
        if prior:
            out["vae2"] = nchw(jax.random.normal(k_vae2, shape))
            out["noise2"] = nchw(jax.random.normal(jax.random.fold_in(k_noise, 1), shape))
        return out

    return draws


TUNE_CASES = {
    "kv_bs1": dict(batch_size=1, grad_accum=1, freeze_model="crossattn_kv", prior=False),
    "crossattn_bs2_prior_accum2": dict(batch_size=2, grad_accum=2,
                                       freeze_model="crossattn", prior=True),
}


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_one_tuning_step_matches_jax(tmp_path, monkeypatch, case):
    """One optimizer step with JAX's draws handed over: the loss and the
    adapters and token row after AdamW."""
    check_tuning_step(tmp_path, monkeypatch, TUNE_CASES[case], SD15)


def check_tuning_step(tmp_path, monkeypatch, c, stack, grad_floor=0.0):
    """The loss, the gradient AdamW is handed (the mean of the micro-steps')
    to 1e-4 of each tensor's largest entry (ε's rule: the backward runs
    through the same layers), and the adapters and token row after AdamW to
    1e-5 of their largest entry.  Entries whose JAX gradient is under
    ``grad_floor`` of its tensor's largest are held to that only within
    2·lr: there Adam's step g/(|g| + 1e-8) is set by the gradient's
    rounding, not by its value (a gradient of 6e-8 next to a largest entry
    of 0.06 moves 0.81·lr in one package and 0.80·lr in the other)."""
    jg, tg = make_pair(seed=1, stack=stack)
    inst = _concept_images(str(tmp_path / "inst"), [(SIZE, SIZE)] * 3)
    cls = _concept_images(str(tmp_path / "cls"), [(SIZE, SIZE)] * 2, seed=5) \
        if c["prior"] else None
    lr = 1e-3
    kw = dict(instance_prompt="ball", class_dir=cls, class_prompt="ball", steps=1,
              lr=lr, image_size=SIZE, batch_size=c["batch_size"],
              grad_accum=c["grad_accum"], freeze_model=c["freeze_model"],
              checkpointing_steps=0)
    losses, jgrads, real_jit = [], [], jax.jit

    def spy_jit(fn, **k):
        f = real_jit(fn, **k)

        def run(*a, **kk):
            out = f(*a, **kk)
            if isinstance(out, tuple) and len(out) == 2 and getattr(out[0], "ndim", 1) == 0:
                losses.append(float(out[0]))          # value_and_grad's loss
                jgrads.append(jax.tree_util.tree_map(np.asarray, out[1]))
            return out
        return run

    monkeypatch.setattr("customnerf_tpu.guidance.sds.StableDiffusionGuidance",
                        lambda opt_: jg)
    monkeypatch.setattr(jax, "jit", spy_jit)
    jcd.train_custom_diffusion(jg.opt, instance_dir=inst,
                               output_dir=str(tmp_path / "jax"), **kw)
    monkeypatch.undo()
    tgrads, step = [], torch.optim.AdamW.step

    def spy_step(self, *a, **k):
        tgrads.append([p.grad.detach().clone() for gr in self.param_groups
                       for p in gr["params"]])
        return step(self, *a, **k)

    monkeypatch.setattr(torch.optim.AdamW, "step", spy_step)
    got_loss = []
    cd.train_custom_diffusion(tg.opt, instance_dir=inst, output_dir=str(tmp_path / "port"),
                              guidance=tg, draws=_jax_draws(1, c["batch_size"], c["prior"]),
                              log=lambda *_: None,
                              on_step=lambda s, v: got_loss.append(v), **kw)
    assert len(losses) == c["grad_accum"] and len(got_loss) == 1
    assert got_loss[0] == pytest.approx(losses[-1], rel=1e-5)
    base = cd.extract_cd_kv(tg.unet, train_q_out=c["freeze_model"] == "crossattn")
    jmean = jax.tree_util.tree_map(lambda *g: np.mean(g, axis=0), *jgrads)
    jg_kv = cd.cd_kv_from_flax(jmean["cd_kv"])
    want_grads = [jg_kv[k][n].numpy() for k in base for n in base[k]] + [jmean["tok_row"]]
    assert len(tgrads) == 1 and len(tgrads[0]) == len(want_grads)
    for want, got in zip(want_grads, tgrads[0]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    jkv, jtok = jcd.load_cd_artifacts(str(tmp_path / "jax"))
    tkv, ttok = cd.load_cd_artifacts(str(tmp_path / "port"))
    jt = cd.cd_kv_from_flax(jkv)
    assert set(jt) == set(tkv) == set(base)
    for (k, n), g in zip([(k, n) for k in base for n in base[k]], want_grads):
        assert set(jt[k]) == set(tkv[k]) == set(base[k])
        want, got = jt[k][n].numpy(), tkv[k][n].numpy()
        scale = np.abs(want).max()
        free = np.abs(g) < grad_floor * np.abs(g).max()
        np.testing.assert_allclose(got[~free], want[~free], rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{k} {n}")
        assert (np.abs(got - want)[free] <= 2 * lr).all(), f"{k} {n}"
        assert free.mean() < 0.01, f"{k} {n}: {free.mean()}"
        assert np.abs(got - base[k][n].numpy()).max() > 1e-4          # it moved
    w, g = jtok["<new1>"], ttok["<new1>"]
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_resume_equals_the_straight_run(tmp_path):
    """4 straight steps (saving checkpoint-2) against 2 + 2 with a resume
    from that checkpoint: bit for bit on the CPU.  A JAX ``checkpoint-N``
    (state.pkl) is refused."""
    _, tg = make_pair(seed=2)
    inst = _concept_images(str(tmp_path / "inst"), [(SIZE, SIZE)] * 2, ".jpg")
    cls = _concept_images(str(tmp_path / "cls"), [(SIZE, SIZE)], seed=5)
    kw = dict(instance_prompt="ball", class_dir=cls, class_prompt="ball", steps=4,
              lr=1e-3, image_size=SIZE, batch_size=1, guidance=tg, log=lambda *_: None)
    straight = str(tmp_path / "straight")
    cd.train_custom_diffusion(tg.opt, inst, output_dir=straight, checkpointing_steps=2, **kw)
    assert os.path.isdir(os.path.join(straight, "checkpoint-2"))
    assert cd._latest_cd_checkpoint(straight).endswith("checkpoint-2")
    resumed = str(tmp_path / "resumed")
    cd.train_custom_diffusion(tg.opt, inst, output_dir=resumed, checkpointing_steps=0,
                              resume_from_checkpoint=os.path.join(straight, "checkpoint-2"),
                              **kw)
    a, ta = cd.load_cd_artifacts(straight)
    b, tb = cd.load_cd_artifacts(resumed)
    for k in a:
        for n in a[k]:
            assert torch.equal(a[k][n], b[k][n]), (k, n)
    np.testing.assert_array_equal(ta["<new1>"], tb["<new1>"])
    jdir = tmp_path / "jaxrun" / "checkpoint-3"
    jdir.mkdir(parents=True)
    (jdir / "state.pkl").write_bytes(b"\x80\x04N.")
    with pytest.raises(ValueError, match="state.pkl.*ROADMAP.*Custom Diffusion resume state"):
        cd.train_custom_diffusion(tg.opt, inst, output_dir=str(tmp_path / "jaxrun"),
                                  resume_from_checkpoint="latest", checkpointing_steps=0, **kw)


def test_merge_concepts_matches_jax(tmp_path):
    jg, tg = make_pair()
    rs = np.random.RandomState(0)
    base = jcd.extract_cd_kv(jg.unet_params)
    dirs = []
    for i in range(2):
        d = str(tmp_path / f"c{i}")
        table = {k: {n: v + 0.1 * rs.randn(*v.shape).astype(np.float32)
                     for n, v in e.items()} for k, e in base.items()}
        jcd.save_cd_artifacts(d, table, {f"<new{i + 1}>": rs.randn(CTX).astype(np.float32)})
        dirs.append(d)
    reg = rs.randn(6, CTX).astype(np.float32)
    cons = [rs.randn(3, CTX).astype(np.float32) for _ in range(2)]
    want = jcd.merge_concepts(dirs, base, reg, cons, steps=5, lr=1e-2)
    got = cd.merge_concepts(dirs, cd.cd_kv_from_flax(base), reg, cons, steps=5, lr=1e-2)
    want = cd.cd_kv_from_flax(want)
    for k in want:
        for n in ("to_k", "to_v"):
            w = want[k][n].numpy()
            np.testing.assert_allclose(got[k][n].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def test_ddim_sample_matches_jax():
    from customnerf_tpu.guidance.sampler import ddim_sample as jddim
    from customnerf_torch.guidance.sampler import ddim_sample
    jg, tg = make_pair()
    jtable = random_table(9)
    jg.cd_kv = {k: {n: jnp.asarray(v) for n, v in e.items()} for k, e in jtable.items()}
    tg.cd_kv = cd.cd_kv_from_flax(jtable)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jddim(jg, "a photo of a bear", key, num_steps=4, height=SIZE,
                            width=SIZE))
    k_init, _ = jax.random.split(key)
    lat = jax.random.normal(k_init, (1, SIZE // 8, SIZE // 8, 4))
    got = ddim_sample(tg, "a photo of a bear", num_steps=4, height=SIZE, width=SIZE,
                      draws=nchw(lat)).numpy()
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    close(got, want)


def test_retrieve_existing_generated_and_refused(tmp_path, monkeypatch, capsys):
    from customnerf_torch.guidance import retrieve as tr
    from customnerf_torch.guidance import sampler
    from customnerf_torch.utils import jpeg
    d = _concept_images(str(tmp_path / "have"), [(16, 16)] * 3)
    assert tr.retrieve("bear", d, 2) == 3                    # used as it is
    with pytest.raises(RuntimeError, match="no guidance model"):
        tr.retrieve("bear", str(tmp_path / "none"), 2)
    _, tg = make_pair()
    monkeypatch.setattr(sampler, "ddim_sample",
                        functools.partial(sampler.ddim_sample, height=SIZE, width=SIZE))
    out = str(tmp_path / "gen")
    assert tr.retrieve("bear", out, 2, guidance=tg) == 2
    assert "no network retrieval" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["00000.jpg", "00001.jpg", "caption.txt", "images.txt"]
    assert open(os.path.join(out, "caption.txt")).read() == "bear\nbear"
    assert open(os.path.join(out, "images.txt")).read().split("\n") == [
        os.path.join(out, "00000.jpg"), os.path.join(out, "00001.jpg")]
    img = jpeg.read(os.path.join(out, "00000.jpg"))
    assert img.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(img, cv2.imread(os.path.join(out, "00000.jpg"))[..., ::-1])


def _weights_dir(tmp_path, stack=SD15):
    """A diffusers directory from ``tests/torch_sd_mirror.py`` (UNet, VAE)
    and a Hugging Face CLIP text model, all at the tiny widths."""
    from transformers import CLIPTextConfig as HFTextConfig, CLIPTextModel as HFText
    from torch_sd_mirror import TorchUNet, TorchVAE
    wdir = tmp_path / "sd"
    (wdir / "unet").mkdir(parents=True)
    (wdir / "vae").mkdir()
    torch.manual_seed(3)
    torch.save(TorchUNet(**stack.unet_kw, use_linear_projection=stack.linear_proj)
               .state_dict(), wdir / "unet" / "diffusion_pytorch_model.bin")
    torch.save(TorchVAE(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                        groups=8).state_dict(),
               wdir / "vae" / "diffusion_pytorch_model.bin")
    HFText(HFTextConfig(vocab_size=ttext.VOCAB, max_position_embeddings=77,
                        **stack.text_kw)).save_pretrained(
        str(wdir / "text_encoder"), safe_serialization=False)
    return str(wdir)


def test_sd_weights_keep_an_added_token_row(tmp_path):
    """A 49408-row text encoder file loads into a table grown by
    ``register_token`` and leaves the added row as it was."""
    from customnerf_torch.guidance.weights import load_sd_weights
    wdir = _weights_dir(tmp_path)
    _, tg = make_pair()
    row = np.arange(CTX, dtype=np.float32)
    assert ttext.register_token(tg.text_encoder, "<new1>", row) == 49408
    load_sd_weights(tg, wdir)
    table = tg.text_encoder.model.text_model.embeddings.token_embedding.weight
    want = torch.load(os.path.join(wdir, "text_encoder", "pytorch_model.bin"),
                      weights_only=True)["text_model.embeddings.token_embedding.weight"]
    assert torch.equal(table[:49408], want)
    np.testing.assert_array_equal(table[49408].numpy(), row)


def test_validate_weights_report_matches_jax(tmp_path, capsys):
    check_drill(tmp_path, capsys, SD15)


def check_drill(tmp_path, capsys, stack, sd_version="1.5"):
    from customnerf_tpu.guidance.validate import validate_weights as jvalidate
    from customnerf_torch.guidance.validate import validate_weights
    wdir = _weights_dir(tmp_path, stack)
    jg, tg = make_pair(stack=stack)
    jopt = JConfig(data_type="synthetic", seed=0, text="a corgi", sd_weights=wdir,
                   sd_version=sd_version)
    want = jvalidate(jopt, guidance=jg)
    got = validate_weights(Config(data_type="synthetic", seed=0, text="a corgi",
                                  sd_weights=wdir, sd_version=sd_version), guidance=tg)
    assert got["sd_version"] == want["sd_version"] == sd_version
    assert "[INFO] loaded UNet weights" in capsys.readouterr().out
    assert set(got) == set(want)
    for name in ("unet", "vae", "text_encoder"):
        assert got[name]["params"] == want[name]["params"], name
        assert got[name]["checksum"] == pytest.approx(want[name]["checksum"], rel=1e-6)
        assert got[name]["dtypes"] == {"float32": got[name]["leaves"]}
    assert got["ok"] and want["ok"] and got["weights_loaded"]
    assert got["eps_prediction"]["shape"] == [2, 4, 8, 8]
    assert got["text_embed"]["checksum"] == pytest.approx(
        want["text_embed"]["checksum"], rel=1e-5)
    assert got["eps_prediction"]["checksum"] == pytest.approx(
        want["eps_prediction"]["checksum"], rel=1e-4)
