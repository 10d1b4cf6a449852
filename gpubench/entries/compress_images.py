"""compress_images: the configuration's photos as decoded (H, W, 3) uint8
RGB arrays on the host, made once from the seed; every request sends the
same `batch` of them in one compress_images call, and its results are
the (index, result) pairs of the call in input order.

Control: reference.Control's arithmetic (the reference in TF32) applied
to each image of the call in turn, in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.harness import bounds, cells, reference
from gpubench.harness.photo import photos


class Driver(cells.Driver):
    def setup(self) -> None:
        c = self.config
        w, h = int(c["width"]), int(c["height"])
        imgs = photos(int(self.traffic["batch"]), w, h, self.seed,
                      self.device, float(c["fine_noise"]))
        self.rgb = [np.ascontiguousarray(x) for x in
                    imgs[..., :3].cpu().numpy()]
        self.size = (w, h)

    def request_items(self) -> int:
        return len(self.rgb)

    def call(self, i: int):
        results = self.system.compress_images(self.rgb)
        if len(results) != len(self.rgb):
            raise RuntimeError(f"compress_images returned {len(results)} "
                               f"results for {len(self.rgb)} images")
        return list(enumerate(results))

    def bound_s(self, key, res) -> float:
        w, h = self.size
        return bounds.image_bound_s(h, w, len(res.compressed_data))

    def case(self, key) -> reference.Case:
        return reference.Case(rgb=self.rgb[key])


class Control(reference.Control):
    """The reference in TF32 in the program's place, for compress_images."""

    def compress_images(self, images):
        out = []
        for img in images:
            rgb = np.ascontiguousarray(img[..., :3])
            image = np.concatenate(
                [rgb, np.full((*rgb.shape[:2], 1), 255, np.uint8)], axis=-1)
            out.append(self._compress(torch.from_numpy(rgb).to(self.device),
                                      image))
        return out
