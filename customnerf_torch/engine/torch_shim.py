"""Reference-format (torch-ngp / tcnn) checkpoints, both ways (counterpart
of ``customnerf_tpu/engine/torch_shim.py``).

A reference ``.pth`` holds, under ``model``:

  * ``pos_en.embeddings`` [table_size, 2]: the grid table itself (the same
    per-level offsets as ``ops/grid.py``);
  * tcnn ``network.params`` / ``density_network.params`` /
    ``rgb_network.params``: flat fp16 (or f32) vectors.  tcnn's
    FullyFusedMLP stores its layers one after the other, each as
    ``[n_out, n_in padded to 16]`` row-major with zero padding, the last
    layer's outputs padded to 16 too;
  * the split-head variants (``--detach_mask_from_field``,
    ``--mask_no_dir``, ``network_grid.py:13-68``) instead carry
    ``rgb_network.rgb_network.params`` and
    ``rgb_network.conf_network.params``.

Both functions work on the flax-layout tree of numpy arrays that
``engine/convert.py`` maps to and from a ``NeRFField`` state dict
(``{"params": {"grid_table", "feature_net": {"hidden_0": {"kernel"}}…}}``,
kernels ``[in, out]``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

FEATURE_DIMS = [32, 64, 64, 64]   # the reference grid's 16 × 2 feature in
DENSITY_DIMS = [64, 64, 1]
RGB_IN = 27 + 64                  # view_en ‖ feature


def _pad16(n: int) -> int:
    return ((n + 15) // 16) * 16


def _unpack_tcnn(flat: np.ndarray, dims: List[int]) -> List[np.ndarray]:
    """dims = [in, hidden, …, out] → per-layer [in, out] kernels, unpadded."""
    kernels, off = [], 0
    for i in range(len(dims) - 1):
        in_w, out_w = dims[i], dims[i + 1]
        in_pad = _pad16(in_w)
        out_pad = _pad16(out_w) if i == len(dims) - 2 else out_w
        n = out_pad * in_pad
        if off + n > flat.size:
            raise ValueError(f"tcnn layout mismatch: layer {i} needs {n} params, "
                             f"{flat.size - off} left")
        w = flat[off:off + n].reshape(out_pad, in_pad)
        kernels.append(np.ascontiguousarray(w[:out_w, :in_w].T))
        off += n
    return kernels


def _pack_tcnn(kernels: List[np.ndarray]) -> np.ndarray:
    """Per-layer [in, out] kernels → one flat f32 vector in tcnn's layout."""
    parts = []
    for i, k in enumerate(kernels):
        w = np.asarray(k, np.float32).T                       # [out, in]
        out_w, in_w = w.shape
        out_pad = _pad16(out_w) if i == len(kernels) - 1 else out_w
        buf = np.zeros((out_pad, _pad16(in_w)), np.float32)
        buf[:out_w, :in_w] = w
        parts.append(buf.reshape(-1))
    return np.concatenate(parts)


def _layers(net: dict, names) -> List[np.ndarray]:
    return [np.asarray(net[n]["kernel"]) for n in names]


def import_reference_checkpoint(path: str, conf_channels: int = 1) -> Dict:
    """A reference ``.pth`` → the flax-layout tree.  The conf net's input
    width (91, or 64 under ``mask_no_dir``) is read off its vector's size;
    ``conf_channels`` (2 with ``keyword2``) cannot be, as tcnn pads the
    outputs to 16, so the caller passes it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k: v.float().numpy() if torch.is_tensor(v) else np.asarray(v)
          for k, v in sd.items()}

    def k(w):
        return {"kernel": w}

    feat = _unpack_tcnn(sd["network.params"], FEATURE_DIMS)
    dens = _unpack_tcnn(sd["density_network.params"], DENSITY_DIMS)
    params = {
        "grid_table": np.ascontiguousarray(sd["pos_en.embeddings"], np.float32),
        "feature_net": {"hidden_0": k(feat[0]), "hidden_1": k(feat[1]),
                        "out": k(feat[2])},
        "density_net": {"hidden_0": k(dens[0]), "out": k(dens[1])},
    }
    if "rgb_network.params" in sd:
        rgb = _unpack_tcnn(sd["rgb_network.params"], [RGB_IN, 64, 3 + conf_channels])
        params["rgb_net"] = {"hidden_0": k(rgb[0]), "out": k(rgb[1])}
    elif "rgb_network.rgb_network.params" in sd:
        rgb = _unpack_tcnn(sd["rgb_network.rgb_network.params"], [RGB_IN, 64, 3])
        conf_flat = sd["rgb_network.conf_network.params"]
        # 64·pad16(in) + 16·64 entries: 7168 for in = 91, 5120 for in = 64
        conf_in = RGB_IN if conf_flat.size == 64 * _pad16(RGB_IN) + 16 * 64 else 64
        conf = _unpack_tcnn(conf_flat, [conf_in, 64, conf_channels])
        params["rgb_net"] = {"hidden_0": k(rgb[0]), "out": k(rgb[1])}
        params["conf_net"] = {"hidden_0": k(conf[0]), "out": k(conf[1])}
    else:
        raise ValueError(f"unrecognized reference rgb head layout in {path}: "
                         f"{sorted(kk for kk in sd if 'rgb' in kk)}")
    return {"params": params}


def export_reference_checkpoint(params, path: str, epoch: int = 0,
                                global_step: int = 0) -> str:
    """The flax-layout tree → a reference-shaped ``.pth`` (tcnn packing in
    f32), so reference tooling can read a field trained here.  A tree with a
    ``conf_net`` writes the split ``RGB_network`` layout."""
    p = params["params"] if "params" in params else params
    model = {
        "pos_en.embeddings": torch.from_numpy(
            np.array(p["grid_table"], np.float32, copy=True)),
        "network.params": torch.from_numpy(_pack_tcnn(
            _layers(p["feature_net"], ("hidden_0", "hidden_1", "out")))),
        "density_network.params": torch.from_numpy(_pack_tcnn(
            _layers(p["density_net"], ("hidden_0", "out")))),
    }
    rgb = torch.from_numpy(_pack_tcnn(_layers(p["rgb_net"], ("hidden_0", "out"))))
    if "conf_net" in p:
        model["rgb_network.rgb_network.params"] = rgb
        model["rgb_network.conf_network.params"] = torch.from_numpy(
            _pack_tcnn(_layers(p["conf_net"], ("hidden_0", "out"))))
    else:
        model["rgb_network.params"] = rgb
    torch.save({"epoch": epoch, "global_step": global_step,
                "stats": {"loss": [], "valid_loss": [], "results": [],
                          "checkpoints": [], "best_result": None},
                "model": model}, path)
    return path
