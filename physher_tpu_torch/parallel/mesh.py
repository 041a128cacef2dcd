"""Device meshes: site-pattern data parallelism over a list of devices.

Port of ``physher_tpu/parallel/mesh.py``. The reference's only scaling axis
is SIMD/OpenMP across site patterns inside one process (reference:
src/phyc/treelikelihood4.c SSE kernels, treelikelihood.c:1426-1452 OpenMP).
The JAX package shards the pattern axis of the tip partials and pattern
weights over a ``jax.sharding.Mesh``; here one process drives a list of
devices, as JAX's single controller drives its mesh:

- :class:`Mesh` is a device array with named axes, ``("patterns",)`` or
  ``("chains", "patterns")``. A device may appear more than once: the CPU
  listed four times gives four pattern shards in one process, as one card
  listed twice gives two.
- :func:`shard_tree_likelihood` gives a ``TreeLikelihood`` its mesh. Its
  engine then runs once per shard, on that shard's pattern columns and
  device, with the P matrices, frequencies and category weights copied
  there; the shards' log-likelihoods are summed on the first device in
  shard order (the reference's weighted root sum, treelikelihood.c:
  1483-1486), so the result does not depend on timing. Autograd carries
  the copied parameters' gradients back to the first device, so no
  collective is needed.
- On a ``("chains", "patterns")`` mesh a batch of L chains splits into
  contiguous groups, one a mesh row, each group's patterns over its row.
"""

from __future__ import annotations

import numpy as np
import torch


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A device array ``devices`` (numpy, of ``torch.device``) with one
    name an axis (``axis_names``)."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device array for axes "
                             f"{axis_names}")
        self.devices = np.vectorize(_device, otypes=[object])(devices)
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def rows(self) -> list:
        """The devices as rows of the pattern axis: one row a chain group
        (one row on a mesh without a chain axis)."""
        return [list(r) for r in self.devices.reshape(
            -1, self.shape["patterns"])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def cuda_devices(n: int | None = None, what: str = "") -> list:
    """The first ``n`` visible CUDA devices (all of them for None); raises,
    naming the count, when fewer are visible."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = count if n is None else n
    if need < 1 or count < need:
        raise ValueError(
            f"{what or f'a mesh of {need} devices'} needs {max(need, 1)} "
            f"CUDA devices but {count} are visible (pass devices=, a list "
            f"that may repeat a device, for more shards than cards)")
    return [torch.device("cuda", i) for i in range(need)]


def pattern_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the pattern (data) axis: ``devices`` as given, or the
    first ``n_devices`` visible CUDA devices (all of them for None)."""
    if devices is None:
        devices = cuda_devices(n_devices)
    return Mesh(list(devices), ("patterns",))


def chain_pattern_mesh(n_chains: int, devices=None) -> Mesh:
    """2-D mesh, chains x patterns, over ``devices`` (every visible CUDA
    device for None) in row-major order."""
    if devices is None:
        devices = cuda_devices()
    devices = list(devices)
    n = len(devices)
    if n % n_chains:
        raise ValueError(f"{n} devices not divisible into {n_chains} chain "
                         f"groups")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_chains, n // n_chains), ("chains", "patterns"))


def mesh_from_shape(shape: dict, devices) -> Mesh:
    """The ``{"chains": c, "patterns": p}`` mesh over ``devices`` (c x p of
    them, row-major): a patterns mesh for c = 1."""
    c, p = shape["chains"], shape["patterns"]
    devices = list(devices)
    if len(devices) != c * p:
        raise ValueError(f"{len(devices)} mesh devices for a {c}x{p} mesh")
    if c > 1:
        return chain_pattern_mesh(c, devices=devices)
    return pattern_mesh(devices=devices)


def shard_tree_likelihood(tlk, mesh: Mesh):
    """Shard a TreeLikelihood's pattern columns over ``mesh``'s pattern
    axis (``TreeLikelihood.set_mesh``, which raises unless the axis
    divides the padded pattern count: the CUDA kernels take any count, so
    there is no tile to align to); returns ``tlk``."""
    tlk.set_mesh(mesh)
    return tlk
