"""A narrow SmallCNN workload for the port's CPU durability tests:
``cifar10_cnn``'s model at width 16 on 8x8 images (every fourth pixel
of the synthetic CIFAR-10 set), batch 32, so a 4-member sweep of 4
generations takes a few seconds on one CPU thread (the bf16 eval of a
1024-image chunk dominates). Not a test module (no ``test_`` prefix):
the durability test files import it."""

import numpy as np

from mpi_opt_tpu_torch.models import SmallCNN
from mpi_opt_tpu_torch.workloads.vision import Cifar10CNN


class NarrowCNN(Cifar10CNN):
    width = 16
    batch_size = 32

    def data(self):
        if self._data is None:
            d = dict(super().data())
            for k in ("train_x", "val_x"):
                d[k] = np.ascontiguousarray(d[k][:, ::4, ::4, :])
            self._data = d
        return self._data

    def _model(self, n_classes, population, device):
        return SmallCNN(n_classes=n_classes, width=self.width, population=population,
                        image_size=8, device=device)


def small_workload():
    return NarrowCNN(n_train=512, n_val=128)


#: the sweep every durability test runs: 4 members, 4 generations of 2
#: steps, one generation a launch
KW = dict(population=4, generations=4, steps_per_gen=2, seed=2, gen_chunk=1, device="cpu")
