"""The port's tokenizers and CLIP towers against the JAX package's, on the
CPU: HashTokenizer ids and the CLIP BPE exactly; the CLIP text transformer's
``last_hidden_state`` against transformers' ``FlaxCLIPTextModel`` and the
ViT-B/32 ``match_probs`` / embeddings against ``FlaxCLIPModel`` (the JAX
package's ``CLIPViewMatcher``), at two layers and narrow widths, weights
carried flax → port through ``engine/convert.py::state_from_flax``.

Tolerances: hidden states 1e-5 of their largest entry (two f32 layers);
match probabilities 1e-5 absolute and embeddings 1e-5 (unit vectors).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import (CLIPConfig, CLIPTextConfig as HFTextConfig,
                          CLIPVisionConfig as HFVisionConfig, FlaxCLIPModel,
                          FlaxCLIPTextModel)

from customnerf_tpu.guidance import bpe as jbpe
from customnerf_tpu.guidance import clip_view as jclip
from customnerf_tpu.guidance import text as jtext
from customnerf_torch.engine.convert import state_from_flax
from customnerf_torch.guidance import bpe as tbpe
from customnerf_torch.guidance import clip_view as tclip
from customnerf_torch.guidance import text as ttext

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guidance import one_thread  # noqa: E402,F401

PROMPTS = ["a corgi in a forest", "A Corgi, front view", "",
           "a photo of a " + "very " * 90 + "big bear", "<new1> dog"]
TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4)
VISION = tclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=4)


def test_hash_tokenizer_ids_are_the_jax_packages():
    np.testing.assert_array_equal(ttext.HashTokenizer()(PROMPTS),
                                  jtext.HashTokenizer()(PROMPTS))


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """The fixture vocab of tests/test_bpe.py: the byte alphabet (and its
    </w> forms), a few merges, the two specials."""
    d = tmp_path_factory.mktemp("tok")
    alphabet = list(jbpe.bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    for ch in alphabet:
        vocab[ch + "</w>"] = len(vocab)
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
              ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>"),
              ("t", "h"), ("th", "e</w>"), ("1", "2")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return str(d)


def test_bpe_matches_the_jax_package_and_transformers(tok_dir):
    from transformers import CLIPTokenizer
    prompts = ["hello world", "The  Hello,   WORLD!!", "a corgi in a forest",
               "hello's world'll 12 123", "héllo wörld", "", "hello " * 200]
    t = tbpe.ClipBPETokenizer.from_dir(tok_dir)
    j = jbpe.ClipBPETokenizer.from_dir(tok_dir)
    hf = CLIPTokenizer.from_pretrained(tok_dir)
    got = t(prompts, max_length=77)
    np.testing.assert_array_equal(got, j(prompts, max_length=77))
    want = hf(prompts, padding="max_length", max_length=77, truncation=True,
              return_tensors="np")["input_ids"]
    np.testing.assert_array_equal(got, want)
    assert t.add_token("<new1>") == j.add_token("<new1>")
    np.testing.assert_array_equal(t(["hello <new1> world"]), j(["hello <new1> world"]))


def test_text_encoder_uses_the_bpe_under_sd_weights(tok_dir, tmp_path):
    os.symlink(tok_dir, tmp_path / "tokenizer")
    from customnerf_torch.guidance.layers import build
    model = build(ttext.CLIPTextModel, ttext.CLIPTextConfig(**TEXT))
    enc = ttext.TextEncoder(weights_dir=str(tmp_path), model=model)
    assert isinstance(enc.tokenizer, tbpe.ClipBPETokenizer)
    assert isinstance(ttext.TextEncoder(model=model).tokenizer, ttext.HashTokenizer)


def test_clip_text_last_hidden_state_matches_flax():
    cfg = HFTextConfig(vocab_size=ttext.VOCAB, max_position_embeddings=77,
                       hidden_act="quick_gelu", **TEXT)
    flax_model = FlaxCLIPTextModel(cfg, seed=3)
    port = ttext.CLIPTextModel(ttext.CLIPTextConfig(**TEXT))
    port.load_state_dict(state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                flax_model.params)))
    ids = jtext.HashTokenizer()(PROMPTS[:4])
    want = np.asarray(flax_model(input_ids=ids).last_hidden_state)
    enc = ttext.TextEncoder(model=port)
    got = enc.encode(PROMPTS[:4]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # [uncond; cond]
    both = enc.get_text_embeds(["a corgi"], ["blurry"])
    torch.testing.assert_close(both[0], enc.encode(["blurry"])[0])
    torch.testing.assert_close(both[1], enc.encode(["a corgi"])[0])


@pytest.fixture(scope="module")
def clip_pair():
    cfg = CLIPConfig.from_text_vision_configs(
        HFTextConfig(max_position_embeddings=77, hidden_act="quick_gelu",
                     projection_dim=16, **TEXT),
        HFVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=4, image_size=224, patch_size=32,
                       hidden_act="quick_gelu", projection_dim=16),
        projection_dim=16)
    flax_model = FlaxCLIPModel(cfg, seed=5)
    params = jax.tree_util.tree_map(np.asarray, flax_model.params)
    jm = jclip.CLIPViewMatcher.__new__(jclip.CLIPViewMatcher)
    jm.model, jm.params, jm.tokenizer = flax_model, flax_model.params, jtext.HashTokenizer()
    jm._match_ids = jm._tokenize(jclip.MATCH_PROMPTS)
    port = tclip.CLIPModel(ttext.CLIPTextConfig(**TEXT), VISION, projection_dim=16)
    port.load_state_dict(state_from_flax(params))
    return jm, tclip.CLIPViewMatcher(model=port)


def test_clip_weights_dir_loads_a_hugging_face_state_dict(clip_pair, tok_dir, tmp_path):
    """``--clip_weights``: ``pytorch_model.bin`` (buffers included, as Hugging
    Face saves them) and the BPE vocab of the same directory."""
    _, tm = clip_pair
    sd = dict(tm.model.state_dict())
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    torch.save(sd, tmp_path / "pytorch_model.bin")
    for f in ("vocab.json", "merges.txt"):
        os.symlink(os.path.join(tok_dir, f), tmp_path / f)
    blank = tclip.CLIPModel(ttext.CLIPTextConfig(**TEXT), VISION, projection_dim=16)
    loaded = tclip.CLIPViewMatcher(weights_dir=str(tmp_path), model=blank)
    assert isinstance(loaded.tokenizer, tbpe.ClipBPETokenizer)
    for k, v in tm.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k


def test_vit_b32_match_probs_and_embeddings_match_flax(clip_pair):
    jm, tm = clip_pair
    assert tm.tokenizer is not None and tclip.VIEW_NAMES == jclip.VIEW_NAMES
    imgs = np.random.RandomState(0).rand(2, 40, 48, 3).astype(np.float32)
    want = jm.match_probs(imgs)
    got = tm.match_probs(torch.tensor(imgs))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.preprocess(imgs).numpy(),
                               np.asarray(jm.preprocess(jnp.asarray(imgs))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.image_embeds(imgs), jm.image_embeds(imgs),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.text_embeds(["a corgi", "a bear"]),
                               jm.text_embeds(["a corgi", "a bear"]), rtol=0, atol=1e-5)
