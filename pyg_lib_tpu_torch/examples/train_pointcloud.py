"""Point-cloud classification: DGCNN EdgeConv over ``ops.knn`` graphs.

    python -m pyg_lib_tpu_torch.examples.train_pointcloud [--device cpu] \
        [--steps 150]

Synthetic shapes (sphere surface, cube shell, two clusters) stand in for
ModelNet. Each step draws one cloud, builds its ``knn`` graph, and takes
one Adam step of an EdgeConv [3, 32, 64] with a global max pool and a
linear head; then the accuracy on fresh clouds is reported. Runs on the
CUDA card unless ``--device`` names another device, and raises when there
is no card.
"""

import argparse
import time

import numpy as np
import torch

from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.models import EdgeConv
from pyg_lib_tpu_torch.utils import _resolve_device


def make_cloud(rng, label, n=128):
    """``n`` points of shape ``label``: 0 a sphere surface, 1 a cube
    shell, 2 two Gaussian clusters (f32 ``[n, 3]``)."""
    if label == 0:
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)
    if label == 1:
        v = rng.uniform(-1, 1, (n, 3))
        face = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        v[np.arange(n), face] = sign
        return v.astype(np.float32)
    c = rng.choice([-0.7, 0.7], (n, 1))
    return (c * np.ones((1, 3)) +
            0.25 * rng.normal(size=(n, 3))).astype(np.float32)


def main(steps: int = 150, k: int = 12, n_pts: int = 128,
         verbose: bool = True, device=None, seed: int = 0) -> float:
    """Train on ``device`` (None: the CUDA card); return the accuracy on
    60 fresh clouds."""
    device = _resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    conv = EdgeConv([3, 32, 64], generator=gen, device=device)
    head_w = (torch.randn((64, 3), generator=gen) * 0.1).to(device)
    head_w.requires_grad_()
    head_b = torch.zeros(3, device=device, requires_grad=True)
    opt = torch.optim.Adam([*conv.parameters(), head_w, head_b], lr=2e-3)

    def forward(pts, idx):
        return conv(pts, idx, k).amax(0) @ head_w + head_b

    def cloud():
        y = int(rng.integers(0, 3))
        pts = torch.from_numpy(make_cloud(rng, y, n_pts)).to(device)
        return y, pts, ops.knn(pts, pts, k=k)

    t0 = time.perf_counter()
    for i in range(steps):
        y, pts, idx = cloud()
        opt.zero_grad()
        loss = -torch.log_softmax(forward(pts, idx), 0)[y]
        loss.backward()
        opt.step()
        if verbose and i % 30 == 0:
            print(f'step {i:4d} loss {loss.item():.4f}')
    correct, trials = 0, 60
    with torch.no_grad():
        for _ in range(trials):
            y, pts, idx = cloud()
            correct += int(forward(pts, idx).argmax()) == y
    acc = correct / trials
    if verbose:
        print(f'accuracy on fresh clouds: {acc:.2f} '
              f'({time.perf_counter() - t0:.1f}s, {device})')
    return acc


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--steps', type=int, default=150)
    args = parser.parse_args()
    main(args.steps, device=args.device)
