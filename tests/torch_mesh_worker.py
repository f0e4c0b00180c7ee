"""The port's runs under ``--mesh_shape``, for ``tests/test_torch_mesh.py``
and ``tests/test_torch_editing_scenes.py``: each ``*_cases(mesh_shape)``
builds tiny trainers on the CPU (torch only) and returns numpy results.
The tests call them in their own process with ``mesh_shape=""`` (the
single-process reference) and run this file as two gloo processes:

    python tests/torch_mesh_worker.py <basics|recon|editing|cli> <rank> <port> <out.npz>

Rank 0 writes the mesh run's results to ``out.npz`` (``cli``: each rank
to ``out.npz.<rank>.npz``)."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from customnerf_torch import config as tconfig  # noqa: E402
from customnerf_torch.data.base import NeRFDataset, RayBatch  # noqa: E402
from customnerf_torch.engine import convert, editing  # noqa: E402
from customnerf_torch.engine.trainer import Trainer, field_config  # noqa: E402
from customnerf_torch.models.field import NeRFField  # noqa: E402
from customnerf_torch.ops import occupancy as tocc  # noqa: E402

RECON_FLAGS = ("-O --grid_type tiled --grid_levels 4 --grid_level_dim 2 "
               "--grid_base_resolution 4 --log2_hashmap_size 10 "
               "--desired_resolution 32 --num_steps 8 --upsample_steps 0 "
               "--compact_frac 1.0 --compact_block 8 --bound 2 --train_conf 0.01 "
               "--soft_mask --data_type synthetic --occ_grid_size 16 --iters 100 "
               "--lr 0.01 --h 16 --w 12 --train_size 4 --max_ray_batch 100 "
               "--use_ckpt scratch").split()
N_RAYS = 64
G = 16
SIDE = 64          # the tiny VAE's sample_size

# tests/test_editing_mesh.py's editing setting, on the port's flags
EDIT = dict(data_type="synthetic", iters=100, lr=5e-3, num_steps=8,
            upsample_steps=4, train_size=4, soft_mask=True, pretrained=True,
            lambda_sd=0.01, keep_bg=10.0, cfg=100.0, random_bg_c=True,
            detach_bg=True, text="a corgi in a forest", text_fg="a corgi",
            grid_levels=4, log2_hashmap_size=10, desired_resolution=32,
            grid_base_resolution=4, use_ckpt="scratch", max_ray_batch=100,
            allow_random_guidance=True)
UNET = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
            cross_attention_dim=32, attention_head_dim=4, norm_num_groups=8)
VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4)


def quiet(*_):
    pass


def f32_field(opt) -> NeRFField:
    """The trainer's field with f32 heads (``-O`` picks bf16 ones)."""
    cfg = dataclasses.replace(field_config(opt), compute_dtype="float32")
    return NeRFField(cfg, seed=opt.seed, device="cpu")


def recon_params(opt) -> dict:
    """The field's flax tree with a random grid table (seed 0)."""
    params = convert.params_to_flax(f32_field(opt).state_dict())
    rng = np.random.RandomState(0)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    return params


def occupancy_grid(seed=2):
    rng = np.random.RandomState(seed)
    return ((rng.rand(2, G ** 3) < 0.3) * 100.0).astype(np.float32)


def ray_batch(n, seed, index=0):
    """n rays from a sphere of radius 1.2-1.5 towards the origin."""
    rng = np.random.RandomState(seed)
    o = np.tile([[0.0, 0.0, -1.2]], (n, 1)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32) * 0.2 + np.asarray([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = rng.rand(n, 3).astype(np.float32)
    mask = (rng.rand(n) < 0.4).astype(np.float32)
    return RayBatch(rgbs=torch.tensor(rgb), mask=torch.tensor(mask),
                    rays_o=torch.tensor(o), rays_d=torch.tensor(d), H=8,
                    W=n // 8, img_path=f"rays{seed}", index=index)


def recon_trainer(mesh_shape, *flags):
    opt = tconfig.parse_args(RECON_FLAGS + list(flags) + ["--mesh_shape", mesh_shape])
    field = f32_field(opt)
    field.load_state_dict(convert.params_from_flax(recon_params(opt)))
    tr = Trainer(opt, field=field, device="cpu", log=quiet)
    tr.occ_state = tocc.state_from_grid(torch.tensor(occupancy_grid()), 1.0, 10.0,
                                        grid_size=G)
    return tr


def grads(tr, prefix):
    return {f"{prefix}/{n}": p.grad.detach().numpy().copy()
            for n, p in tr.field.named_parameters()}


def params(tr, prefix):
    return {f"{prefix}/{n}": p.detach().numpy().copy()
            for n, p in tr.field.named_parameters()}


def prime_adam(tr, count=1000):
    """A non-fresh Adam state (zero first moments, unit second moments, a
    large count): an update is then ≈ lr·0.1·g, linear in the gradient, so
    runs whose gradients differ by their summation order stay close (a
    fresh state's first update is ±lr whatever |g| is)."""
    for group in tr.optimizer.param_groups:
        for p in group["params"]:
            tr.optimizer.state[p] = {"step": torch.tensor(float(count)),
                                     "exp_avg": torch.zeros_like(p),
                                     "exp_avg_sq": torch.ones_like(p)}
    tr.n_updates = count


def recon_cases(mesh_shape: str) -> dict:
    """A step without jitter (compaction on, 64 rays in blocks of 8), a
    step with jitter, a step whose blocks overflow (150 rays: 5 blocks of
    32, which do not divide two ranks, at ``compact_frac`` 0.3), a K = 2 group
    from a primed Adam state, and ``render_image`` of a validation view
    (two chunk rows and a padded tail) without and with jitter."""
    out = {}
    tr = recon_trainer(mesh_shape)
    b0, b1, b2 = ray_batch(N_RAYS, 1), ray_batch(N_RAYS, 3), ray_batch(N_RAYS, 4)
    loss, _, _ = tr.train_step(b0, perturb=False)
    out.update(grads(tr, "step"), **{"step/loss": np.float32(loss)})
    loss, _, _ = tr.train_step(b1, perturb=True)
    out.update(grads(tr, "jitter"), **{"jitter/loss": np.float32(loss)})
    tr = recon_trainer(mesh_shape, "--compact_frac", "0.3", "--compact_block", "32")
    loss, _, stats = tr.train_step(ray_batch(150, 6), perturb=True)
    out.update(grads(tr, "overflow"), **{"overflow/loss": np.float32(loss)})
    out["overflow_frac"] = np.float32(stats["overflow_frac"])
    tr = recon_trainer(mesh_shape)
    prime_adam(tr)
    losses, _ = tr.train_many([b1, b2])
    out.update(params(tr, "group"), **{"group/losses": losses.numpy()})
    view = NeRFDataset(tr.opt, "val", device="cpu").dataloader().item(0)
    for name, perturb in (("render", False), ("render_jitter", True)):
        r = tr.render_image(view.rays_o, view.rays_d, perturb=perturb)
        out[f"{name}/image"] = r["image"].numpy()
        out[f"{name}/depth"] = r["depth"].numpy()
        out[f"{name}/fg"] = r["fg"]["image"].numpy()
    return out


# -------------------------------------------------------------- editing
def tiny_guidance(opt):
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    from customnerf_torch.guidance.text import CLIPTextConfig, CLIPTextModel, TextEncoder
    from customnerf_torch.guidance.unet import UNetConfig
    from customnerf_torch.guidance.vae import VAEConfig
    text = TextEncoder(model=build(CLIPTextModel, CLIPTextConfig(**TEXT),
                                   generator=torch.Generator().manual_seed(0)))
    return StableDiffusionGuidance(opt, device="cpu", unet_cfg=UNetConfig(**UNET),
                                   vae_cfg=VAEConfig(**VAE, sample_size=SIDE),
                                   text_encoder=text)


def edit_trainer(mesh_shape, ws, **kw):
    opt = tconfig.Config(**dict(EDIT, workspace=ws, mesh_shape=mesh_shape, **kw))
    tr = Trainer(opt, device="cpu", log=quiet, guidance=tiny_guidance(opt))
    g = torch.Generator().manual_seed(7)
    tr.text_z = torch.randn(2, 77, 32, generator=g)
    tr.text_z_fg = torch.randn(2, 77, 32, generator=g)
    if opt.cuda_ray:
        tr.occ_state = tocc.state_from_grid(torch.tensor(occupancy_grid(5)), 1.0,
                                            10.0, grid_size=G)
    return tr


def scene_state(tr, S=2):
    """S scenes from the trainer's field: scene i's grid table scaled by
    1 + 0.1·i, a primed Adam state."""
    sd = {k: v.detach() for k, v in tr.field.state_dict().items()}
    params_s = editing.stack_trees([
        {k: (v * (1 + 0.1 * i) if k == "grid_table" else v) for k, v in sd.items()}
        for i in range(S)])
    opt_s = {"step": torch.full((S,), 1000.0),
             "exp_avg": {k: torch.zeros_like(v) for k, v in params_s.items()},
             "exp_avg_sq": {k: torch.ones_like(v) for k, v in params_s.items()}}
    return params_s, opt_s


def editing_cases(mesh_shape: str, ws: str) -> dict:
    """Sharded single-scene editing on ``data`` (a square frame on the dense
    path; a 13×11 frame, whose 143 rays do not divide the axis, on ``-O``
    with compaction), a K = 2 ``editing_steps_many`` group, and the S = 2
    multi-scene step."""
    out = {}
    data = mesh_shape.replace("scene", "data")      # the data-axis runs
    for name, kw in (("square", dict(h=16, w=16)),
                     ("nonsquare", dict(h=13, w=11, cuda_ray=True, compact_frac=0.5,
                                        compact_block=8))):
        tr = edit_trainer(data, os.path.join(ws, name), **kw)
        batch = NeRFDataset(tr.opt, "train", device="cpu").dataloader().item(0)
        assert name == "square" or batch.H * batch.W % 2 == 1
        tr.global_step = 1
        loss, aux, _ = editing.editing_step(tr, batch)
        out.update(grads(tr, name))
        out[f"{name}/loss_sds"] = np.float32(aux["loss_sds"])
        out[f"{name}/loss_bg"] = np.float32(aux["loss_bg"])
    tr = edit_trainer(data, os.path.join(ws, "many"), h=16, w=16)
    prime_adam(tr)
    loader = NeRFDataset(tr.opt, "train", device="cpu").dataloader()
    losses, _ = editing.editing_steps_many(tr, [loader.item(0), loader.item(1)])
    out.update(params(tr, "many"), **{"many/losses": losses.numpy()})

    for name, shape in (("scenes", mesh_shape), ("scenes_data", data)):
        tr = edit_trainer(shape, os.path.join(ws, name), h=12, w=10, cuda_ray=True)
        loader = NeRFDataset(tr.opt, "train", device="cpu").dataloader()
        params_s, opt_s = scene_state(tr)
        p1, o1, losses, aux = editing.editing_step_scenes(
            tr, [loader.item(0), loader.item(1)], params_s, opt_s)
        out.update({f"{name}/{k}": v.numpy() for k, v in p1.items()})
        out.update({f"{name}/m/{k}": v.numpy() for k, v in o1["exp_avg"].items()})
        out[f"{name}/step"] = o1["step"].numpy()
        out[f"{name}/losses"] = losses.numpy()
        out[f"{name}/loss_sds"] = aux["loss_sds"].numpy()
    return out


def basics_cases() -> dict:
    """``make_mesh`` specs (the JAX ``tests/test_parallel.py:13-22``),
    ``shard_batch``, ``replicate``, the gradient sum and a gathered
    ``RayShard`` with its backward, in a world of two."""
    import pytest
    from customnerf_torch.parallel.mesh import (RayShard, all_reduce_sum, make_mesh,
                                                replicate, shard_batch)
    rank = torch.distributed.get_rank()
    assert make_mesh("") is None
    m = make_mesh("data:2")
    assert m.axis_names == ("data",) and m.shape == {"data": 2}
    assert m.coords == {"data": rank} and m.ranks.shape == (2,)
    m2 = make_mesh("scene:2,data:1")
    assert m2.shape == {"scene": 2, "data": 1} and m2.coords == {"scene": rank, "data": 0}
    for bad in ("data:999", "data:1"):
        with pytest.raises(ValueError):
            make_mesh(bad)
    x = torch.arange(12.0).reshape(6, 2)
    part = shard_batch(m, {"x": x})["x"]
    assert torch.equal(part, x[3 * rank:3 * rank + 3])
    with pytest.raises(ValueError):
        shard_batch(m, torch.zeros(5))
    mod = torch.nn.Linear(3, 2)
    with torch.no_grad():
        mod.weight.fill_(float(rank + 1))
    state = {"t": torch.full((4,), float(rank + 5))}
    replicate(m, (mod, state))
    assert torch.equal(mod.weight.detach(), torch.ones(2, 3))
    assert torch.equal(state["t"], torch.full((4,), 5.0))
    gs = [torch.full((3,), float(rank + 1)), torch.full((2, 2), 10.0 * (rank + 1))]
    all_reduce_sum(gs, m)
    assert torch.equal(gs[0], torch.full((3,), 3.0)) and torch.equal(gs[1], torch.full((2, 2), 30.0))
    out = {}
    for block in (None, 4):
        shard = RayShard(m, 21, block=block)
        full = torch.arange(21.0)[:, None] * torch.tensor([1.0, -1.0])
        local = shard.take(full).requires_grad_(True)
        gathered = shard.gather(local * 2.0)
        assert torch.equal(gathered, 2.0 * full)
        (gathered * torch.arange(21.0)[:, None]).sum().backward()
        want = torch.cat([torch.arange(21.0), torch.zeros(shard.n_padded - 21)])
        want = 2.0 * want[shard.rows][:, None].expand(-1, 2)
        assert torch.equal(local.grad, want)
        assert shard.n_padded == (22 if block is None else 24)
        out[f"rows{block}"] = shard.rows.numpy()
    return out


def cli_case(rank: int, port: str, ws: str) -> dict:
    """``customnerf_torch.__main__.main`` under ``--mesh_shape data:2``,
    configured by the environment as torchrun configures it: train with
    evaluations, then the test path; what this rank wrote."""
    from customnerf_torch.__main__ import main as cli
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2",
                      RANK=str(rank), LOCAL_RANK=str(rank))
    flags = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
             "--num_steps 8 --upsample_steps 0 --compact_frac 0.35 --compact_block 8 "
             "--bound 2 --train_conf 0.01 --soft_mask --data_type synthetic --h 16 "
             "--w 16 --train_size 6 --iters 12 --update_extra_interval 2 "
             "--occ_grid_size 16 --max_ray_batch 1000 --max_steps 32 --ckpt scratch "
             "--mesh_shape data:2").split()
    tr = cli(flags + ["--workspace", ws], log=quiet, device="cpu")
    written = sorted(os.path.relpath(os.path.join(d, f), ws)
                     for d, _, fs in os.walk(ws) for f in fs)
    return {"losses": np.asarray(tr.stats["loss"]),
            "results": np.asarray(tr.stats["results"]),
            "global_step": np.int64(tr.global_step), "written": np.asarray(written)}


def main():
    import tempfile

    from customnerf_torch.parallel.mesh import init_distributed
    case, rank, port, path = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    if case == "cli":
        with tempfile.TemporaryDirectory() as ws:
            np.savez(f"{path}.{rank}", **cli_case(rank, port, ws))
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        print("WORKER_OK", rank, flush=True)
        return
    assert init_distributed(f"localhost:{port}", num_processes=2, process_id=rank,
                            log=quiet)
    if case == "basics":
        out = basics_cases()
    elif case == "recon":
        out = recon_cases("data:2")
    else:
        with tempfile.TemporaryDirectory() as ws:
            out = editing_cases("scene:2", ws)
    if rank == 0:
        np.savez(path, **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
