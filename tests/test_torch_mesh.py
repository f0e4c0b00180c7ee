"""``--mesh_shape`` on the port (``customnerf_torch/parallel/mesh.py``,
``Trainer`` under a ``data`` axis) against one process and the JAX package.

Two gloo processes on the CPU run ``tests/torch_mesh_worker.py`` (the
pattern of ``tests/test_multihost.py``: a free localhost port and
subprocesses, each joined within a time limit of its own, failing rather
than hanging).  The ``data:2`` reconstruction step with compaction on
(``compact_frac`` 1.0, blocks of 8, as ``tests/test_parallel.py:105-153``)
must equal the single-process port step and the JAX single-device step
from the same converted parameters, gradients at rtol 2e-3 and atol 1e-6
(that test's tolerance; the ranks sum their gradients in another order).
A K = 2 group under the mesh and a sharded ``render_image`` (as
``tests/test_sharded_eval.py``, rtol 1e-4 and atol 1e-5) equal the
single-process run."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.engine.trainer import build_encoder_spec
from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch.engine import convert
from customnerf_torch.parallel.mesh import init_distributed, make_mesh, pad_to_multiple

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_worker as worker  # noqa: E402

JOIN_S = 120


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def run_two_ranks(case: str, tmp_path, each=False):
    """``tests/torch_mesh_worker.py case`` as ranks 0 and 1 of a gloo world;
    rank 0's results (``each``: both ranks')."""
    out = str(tmp_path / f"{case}.npz")
    port = str(_free_port())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
                               case, str(r), port, out], env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, \
            f"rank {r} failed (rc {p.returncode}):\n{log[-4000:]}"
    def load(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if each:
        return [load(f"{out}.{r}.npz") for r in range(2)]
    return load(out)


def close_leaves(got, want, prefix, rtol, atol):
    keys = sorted(k for k in want if k.startswith(prefix + "/"))
    assert keys and keys == sorted(k for k in got if k.startswith(prefix + "/"))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def recon(tmp_path_factory):
    torch.set_num_threads(2)
    return (run_two_ranks("recon", tmp_path_factory.mktemp("recon")),
            worker.recon_cases(""))


def test_make_mesh_specs_in_one_process(monkeypatch):
    """``''`` → None, a one-rank axis, and ``ValueError`` for a mesh that
    needs more ranks than the world (one process here) has."""
    assert make_mesh("") is None
    m = make_mesh("data:1")
    assert m.shape == {"data": 1} and m.coords == {"data": 0} and m.size("scene") == 1
    with pytest.raises(ValueError, match="needs 8 ranks, have 1"):
        make_mesh("data:8")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_mesh("scene:2,data:4")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False


def test_pad_to_multiple_edge_and_constant():
    x = torch.arange(30.0).reshape(10, 3)
    padded, n = pad_to_multiple(x, 8, mode="edge")
    assert padded.shape == (16, 3) and n == 10
    assert torch.equal(padded[10:], x[-1:].expand(6, 3))
    zeros, _ = pad_to_multiple(x, 8)
    assert torch.equal(zeros[10:], torch.zeros(6, 3))
    same, n = pad_to_multiple(torch.ones(16, 3), 8, mode="edge")
    assert same.shape == (16, 3) and n == 16
    rays = torch.nn.functional.normalize(torch.randn(5, 3), dim=-1)
    assert bool((pad_to_multiple(rays, 4, mode="edge")[0].norm(dim=-1) > 0.99).all())
    with pytest.raises(ValueError):
        pad_to_multiple(x, 4, mode="reflect")


def test_two_ranks_mesh_collectives_and_ray_shard(tmp_path):
    """Specs, ``shard_batch``, ``replicate``, the gradient sum and a
    ``RayShard``'s gather and backward, checked inside both ranks; the
    compaction shard holds whole blocks of ``ray_permutation``'s order."""
    from customnerf_torch.ops.compaction import ray_permutation
    out = run_two_ranks("basics", tmp_path)
    np.testing.assert_array_equal(out["rowsNone"], np.arange(11))
    perm, _ = ray_permutation(24)
    np.testing.assert_array_equal(out["rows4"], perm[:12])


def jax_step_grads():
    """The JAX single-device step of ``tests/test_parallel.py:105-153`` on
    the worker's field, occupancy grid and rays: ``render_rays_fast``
    (compact_frac 1.0, blocks of 8, no jitter) and the trainer's loss."""
    jopt = jconfig.parse_args(worker.RECON_FLAGS)
    topt = worker.tconfig.parse_args(worker.RECON_FLAGS)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=build_encoder_spec(jopt)))
    occ = jocc.state_from_grid(worker.occupancy_grid(), 1.0, density_thresh=10.0,
                               grid_size=worker.G)
    b = worker.ray_batch(worker.N_RAYS, 1)
    o, d = jnp.asarray(b.rays_o.numpy()), jnp.asarray(b.rays_d.numpy())
    rgb, mask = jnp.asarray(b.rgbs.numpy()), jnp.asarray(b.mask.numpy())
    s = jren.RenderSettings(bound=2.0, num_steps=8, upsample_steps=0, soft_mask=True)

    def loss_fn(p):
        out = jren.render_rays_fast(jf, p, o, d, occ, jax.random.PRNGKey(1), s,
                                    n_coarse=16, n_keep=8, train=True, perturb=False,
                                    compact_frac=1.0, compact_block=8)
        return (jopt.train_rgb * jnp.mean((out["image"] - rgb) ** 2)
                + jopt.train_conf * jnp.mean((out["render_mask"][..., 0] - mask) ** 2))

    params = jax.tree_util.tree_map(jnp.asarray, worker.recon_params(topt))
    loss, g = jax.value_and_grad(loss_fn)(params)
    g = convert.params_from_flax(jax.tree_util.tree_map(np.asarray, g))
    return float(loss), {f"step/{k}": v.numpy() for k, v in g.items()}


def test_data2_recon_step_matches_one_process_and_jax(recon):
    mesh, single = recon
    assert mesh["step/loss"] == pytest.approx(float(single["step/loss"]), rel=1e-6)
    close_leaves(mesh, single, "step", rtol=2e-3, atol=1e-6)
    jloss, jgrads = jax_step_grads()
    assert float(single["step/loss"]) == pytest.approx(jloss, rel=1e-5)
    jgrads["step/loss"] = np.float32(jloss)
    close_leaves(single, jgrads, "step", rtol=2e-3, atol=1e-6)
    close_leaves(mesh, jgrads, "step", rtol=2e-3, atol=1e-6)


def test_data2_recon_step_with_jitter_matches_one_process(recon):
    """The march jitter: each rank keeps its rows of the single-process draw."""
    mesh, single = recon
    assert mesh["jitter/loss"] == pytest.approx(float(single["jitter/loss"]), rel=1e-6)
    close_leaves(mesh, single, "jitter", rtol=2e-3, atol=1e-6)


def test_data2_recon_step_with_overflow_matches_one_process(recon):
    """150 rays in blocks of 32: the 5 blocks of the single-process plan
    do not divide two ranks (a block of padding follows them), and at
    ``compact_frac`` 0.3 blocks overflow and take another quadrature scale;
    jitter on."""
    mesh, single = recon
    assert 0 < float(single["overflow_frac"]) < 1
    assert mesh["overflow/loss"] == pytest.approx(float(single["overflow/loss"]), rel=1e-6)
    close_leaves(mesh, single, "overflow", rtol=2e-3, atol=1e-6)


def test_data2_k2_group_matches_one_process(recon):
    """A K = 2 group under the mesh (a plain loop) from a primed Adam state:
    the losses and the parameters after it."""
    mesh, single = recon
    np.testing.assert_allclose(mesh["group/losses"], single["group/losses"], rtol=1e-6)
    close_leaves(mesh, single, "group", rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("name", ["render", "render_jitter"])
def test_data2_render_image_matches_one_process(recon, name):
    """Each chunk row split over the ranks and gathered (two rows of 100
    rays and a padded tail), with and without the march jitter."""
    mesh, single = recon
    close_leaves(mesh, single, name, rtol=1e-4, atol=1e-5)


def test_cli_data2_from_the_environment(tmp_path):
    """``python -m customnerf_torch``'s ``main`` as two ranks configured by
    torchrun's environment: both train the same (losses and eval PSNRs
    equal), only the first writes checkpoints, strips and test frames."""
    r0, r1 = run_two_ranks("cli", tmp_path, each=True)
    assert int(r0["global_step"]) == int(r1["global_step"]) == 12
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    np.testing.assert_array_equal(r0["results"], r1["results"])
    assert np.isfinite(r0["losses"]).all() and len(r0["results"]) == 2
    written = set(r0["written"].tolist())
    assert {"checkpoints/df.pth", "checkpoints/df_ep0002.pth",
            "validation/df_ep0002.png", "results/df_ep0002_test/000.png"} <= written
    assert r1["written"].size == 0
