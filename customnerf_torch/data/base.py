"""Dataset facade + fixed-shape device-resident ray batches (the port's copy
of ``customnerf_tpu/data/base.py``).

Every split precomputes all rays once into stacked arrays and
:meth:`Provider.finalize` puts them on the given torch device, so the
training loop moves nothing but an integer index.  Item contract: the
reference tuple ``(rgbs, mask, rays_o, rays_d, H, W, img_path)``
(provider.py:179-181); the train split draws a random image per step and
has length ``train_size`` (provider.py:166-176).
"""

from __future__ import annotations

import dataclasses
from typing import List

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
        self.images_flat = stack(self.images, 3)
        self.masks_flat = stack(self.masks, 0)
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
        img_idx = min(index, self.images_flat.shape[0] - 1)
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
    """Facade over the providers; this slice ports ``--data_type synthetic``."""

    def __init__(self, opt, type: str = "train", device=None):
        self.opt = opt
        self.type = type
        if opt.data_type != "synthetic":
            raise NotImplementedError(
                f"--data_type {opt.data_type} is not ported yet (ROADMAP.md "
                f"queue A, item 'data formats'); use --data_type synthetic")
        from customnerf_torch.data.synthetic import SyntheticProvider
        self.dataset = SyntheticProvider(split=type, opt=opt,
                                         device=resolve_device(device))

    def dataloader(self):
        return self.dataset
