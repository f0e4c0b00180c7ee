"""Dataset facade + fixed-shape device-resident ray batches (the port's copy
of ``customnerf_tpu/data/base.py``).

Every split precomputes all rays once into stacked arrays on the host and
:meth:`Provider.finalize` puts them on the given torch device, so the
training loop moves nothing but an integer index.  Item contract: the
reference tuple ``(rgbs, mask, rays_o, rays_d, H, W, img_path)``
(provider.py:179-181); the train split draws a random image per step and
has length ``train_size`` (provider.py:166-176); a test split of
synthesised poses serves image 0 (or zeros) as its placeholder target.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from customnerf_torch.device import resolve_device


@dataclasses.dataclass
class RayBatch:
    rgbs: torch.Tensor     # [H*W, 3]
    mask: torch.Tensor     # [H*W]
    rays_o: torch.Tensor   # [H*W, 3]
    rays_d: torch.Tensor   # [H*W, 3]
    H: int
    W: int
    img_path: str
    index: int


class Provider:
    """Base provider: subclasses fill images/masks/origins/directions."""

    def __init__(self, split: str, train_size: int, seed: int = 0):
        self.split = split
        self.train_size = train_size
        self.rng = np.random.RandomState(seed)
        self.images: List[np.ndarray] = []      # each [H, W, 3]
        self.masks: List[np.ndarray] = []       # each [H, W]
        self.origins: List[np.ndarray] = []     # each [H, W, 3]
        self.directions: List[np.ndarray] = []  # each [H, W, 3]
        self.images_lis: List[str] = []
        self.H: List[int] = []
        self.W: List[int] = []
        self.n_images = 0
        self._stacked = False

    def finalize(self, device):
        """Flatten per-image arrays to [n, H*W, c] stacks on ``device``."""
        def stack(xs, ch):
            a = np.stack([x.reshape(-1, ch) if ch else x.reshape(-1) for x in xs])
            return torch.from_numpy(a.astype(np.float32)).to(device)

        self.n_images = len(self.origins)
        if self.images:
            self.images_flat = stack(self.images, 3)
            self.masks_flat = stack(self.masks, 0)
        else:  # test split with synthesised poses only
            hw = self.origins[0].shape[0] * self.origins[0].shape[1]
            self.images_flat = torch.zeros(1, hw, 3, device=device)
            self.masks_flat = torch.zeros(1, hw, device=device)
        self.origins_flat = stack(self.origins, 3)
        self.directions_flat = stack(self.directions, 3)
        self._stacked = True

    def __len__(self):
        if self.split == "train":
            return self.train_size
        return self.n_images

    def item(self, index: int) -> RayBatch:
        assert self._stacked, "call finalize() first"
        if self.split == "train":
            index = int(self.rng.randint(0, self.n_images))
        img_idx = 0 if self.split == "test" and len(self.images) <= 1 else index
        img_idx = min(img_idx, self.images_flat.shape[0] - 1)
        path = self.images_lis[index] if index < len(self.images_lis) else str(index)
        return RayBatch(
            rgbs=self.images_flat[img_idx],
            mask=self.masks_flat[img_idx],
            rays_o=self.origins_flat[index],
            rays_d=self.directions_flat[index],
            H=self.H[0],
            W=self.W[0],
            img_path=path,
            index=index,
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self.item(i)


class NeRFDataset:
    """Facade dispatching the dtu / nerfstudio / llff / synthetic providers
    (reference provider.py:643-696); the train split reads images at
    ``--train_resolution_level``, the others at ``--eval_resolution_level``.
    ``R_path``: a saved [n, 4, 4] pose correction applied to every view."""

    def __init__(self, opt, type: str = "train", R_path: Optional[str] = None,
                 device=None):
        self.opt = opt
        self.type = type
        self.training = type in ("train", "all")
        device = resolve_device(device)
        resolution_level = (opt.train_resolution_level if self.training
                            else opt.eval_resolution_level)
        kw = dict(split=type, resolution_level=resolution_level, opt=opt,
                  R_path=R_path, device=device)
        if opt.data_type == "nerfstudio":
            from customnerf_torch.data.nerfstudio import NerfstudioProvider
            self.dataset = NerfstudioProvider(data_dir=opt.data_path, **kw)
        elif opt.data_type == "dtu":
            from customnerf_torch.data.dtu import DTUProvider
            self.dataset = DTUProvider(data_dir=opt.data_path, **kw)
        elif opt.data_type == "llff":
            from customnerf_torch.data.llff import LLFFProvider
            self.dataset = LLFFProvider(data_dir=opt.data_path, **kw)
        elif opt.data_type == "synthetic":
            from customnerf_torch.data.synthetic import SyntheticProvider
            self.dataset = SyntheticProvider(split=type, opt=opt, device=device)
        else:
            raise ValueError(f"unsupported data type {opt.data_type}")

    def dataloader(self):
        return self.dataset
