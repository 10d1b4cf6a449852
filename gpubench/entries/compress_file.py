"""compress_file: the configuration's photos as baseline JPEG files,
written by the benchmark's own writer (jpeg.write, at the
configuration's input quality, with the mix's EXIF orientation), cycled;
each result written to one path in the run's temporary directory."""

from __future__ import annotations

import os

import numpy as np
import torch

from gpubench.harness import bounds, cells, jpeg, plain, reference
from gpubench.harness.photo import photos


class Driver(cells.Driver):
    def setup(self) -> None:
        c, t = self.config, self.traffic
        w, h, q = int(c["width"]), int(c["height"]), int(c["input_quality"])
        self.orientation = int(t.get("orientation", 1))
        imgs = photos(int(t["distinct"]), w, h, self.seed, self.device,
                      float(c["fine_noise"]))
        self.paths, self.levels, self.nnz, sizes = [], [], [], []
        for i in range(imgs.shape[0]):
            levels = plain.quantize(plain.forward(imgs[i, ..., :3],
                                                  "float64"), q)
            data = jpeg.write(levels, w, h, q,
                              self.orientation if self.orientation != 1
                              else None)
            path = os.path.join(self.tmp, f"in{i}.jpg")
            with open(path, "wb") as f:
                f.write(data)
            self.paths.append(path)
            host = [lv.reshape(*lv.shape[:2], 64).to(torch.int16).cpu()
                    .numpy() for lv in levels]
            self.levels.append(host)
            self.nnz.append(sum(int(np.count_nonzero(x)) for x in host))
            sizes.append(len(data))
        self.notes["input_bytes_per_pixel"] = float(np.mean(sizes)) / (w * h)
        self.size = (w, h)
        self.out_path = os.path.join(self.tmp, "out.jpg")

    def call(self, i: int):
        k = i % len(self.paths)
        return [(k, self.system.compress_file(self.paths[k], self.out_path))]

    def bound_s(self, key, res) -> float:
        w, h = self.size
        return bounds.image_bound_s(h, w, len(res.compressed_data),
                                    decode_nnz=self.nnz[key])

    def case(self, key) -> reference.Case:
        return reference.Case(levels=self.levels[key],
                              quality=int(self.config["input_quality"]),
                              orientation=self.orientation, size=self.size)
