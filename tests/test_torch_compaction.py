"""Cross-ray compaction of the port against the JAX package: ``compact_plan``
keep, slot, ``slot_valid`` and ``block_scale`` must be identical (integer
and boolean outputs exactly, the f32 scale bit for bit) in the exact regime
and in the overflow regime; the index-form pack/unpack must equal the JAX
one-hot matmuls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.ops import compaction as jcomp
from customnerf_torch.ops import compaction as tcomp


def _jax_keep_slot(onehot):
    oh = np.asarray(onehot).astype(np.float32)          # [NB, G·K, M]
    keep = oh.sum(-1) > 0
    slot = np.where(keep, oh.argmax(-1), oh.shape[-1])
    return keep, slot


@pytest.mark.parametrize("budget,p", [(24, 0.4), (12, 0.4), (6, 0.9), (128, 0.5)],
                         ids=["exact", "overflow", "overflow_dense", "wide"])
def test_compact_plan_identical(budget, p):
    rng = np.random.RandomState(budget)
    N, K, G = 32, 6, 4
    budget = min(budget, G * K)
    valid = rng.rand(N, K) < p
    onehot, jsv, jscale = jcomp.compact_plan(jnp.asarray(valid), G, budget)
    keep, slot, sv, scale = tcomp.compact_plan(torch.tensor(valid), G, budget)
    jkeep, jslot = _jax_keep_slot(onehot)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    overflow = valid.reshape(N // G, -1).sum(-1) > budget
    assert (scale.numpy()[:, 0] > 1).tolist() == overflow.tolist()
    if budget == 12:
        assert overflow.any() and not overflow.all()


def test_pack_and_unpack_equal_onehot_matmuls():
    rng = np.random.RandomState(0)
    N, K, G, M = 16, 8, 4, 12                      # overflows some blocks
    valid = rng.rand(N, K) < 0.5
    vals = rng.randn(N, K, 3).astype(np.float32)
    vals_c, onehot, sv, _ = jcomp.compact_blocks(jnp.asarray(valid),
                                                 jnp.asarray(vals), G, M)
    keep, slot, tsv, _ = tcomp.compact_plan(torch.tensor(valid), G, M)
    src = tcomp.slot_sources(slot, M)                       # [NB, M]
    v = torch.tensor(vals).reshape(N // G, G * K, 3)
    packed = torch.gather(v, 1, src[..., None].expand(-1, -1, 3))
    packed = packed * tsv[..., None]
    np.testing.assert_array_equal(packed.numpy(), np.asarray(vals_c))
    out_c = rng.randn(N // G, M, 2).astype(np.float32) * np.asarray(sv)[..., None]
    want = np.asarray(jcomp.uncompact_blocks(onehot, jnp.asarray(out_c)))
    rows = torch.where(keep, slot, torch.full_like(slot, M))
    padded = torch.cat([torch.tensor(out_c), torch.zeros(N // G, 1, 2)], 1)
    got = torch.gather(padded, 1, rows[..., None].expand(-1, -1, 2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_budget_and_ray_permutation():
    for args in [(64, 40, 0.35), (16, 40, 0.5), (16, 40, 1.0), (4, 8, 0.1),
                 (32, 40, 0.4)]:
        assert tcomp.block_budget(*args) == jcomp.block_budget(*args)
    assert tcomp.block_budget(64, 40, 0.35) == 896        # the flagship
    for n in (40, 128, 2394, 16384, 7919 * 2):
        tp, ti = tcomp.ray_permutation(n)
        jp, ji = jcomp.ray_permutation(n)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ti, ji)


def test_compact_plan_rejects_ragged_blocks():
    with pytest.raises(ValueError):
        tcomp.compact_plan(torch.ones(10, 4, dtype=torch.bool), 4, 8)
