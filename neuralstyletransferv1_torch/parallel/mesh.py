"""The device mesh and the sharded stylize and temporal chain.

Counterpart of ``neuralstyletransferv1_tpu/parallel/mesh.py``. JAX builds a
1-D ``Mesh`` over its devices in one process and lets XLA split the batch;
here a ``Mesh`` is an ordered tuple of ``torch.device``s driven from one
host thread: the frame batch splits on dim 0 into one equal chunk per
device, each chunk's work is issued on its device (CUDA launches are
asynchronous, so the cards run together), and the outputs gather, in order,
on the first device. There is no collective: the only traffic is each
chunk's copy to its device, the outputs' copy back, and the temporal
chain's one-frame halo between neighbouring shards.

A device may appear more than once (two shards on one card run every line
of the sharded code there); shards on the same device share one copy of the
weights, and the first device (the primary) keeps the caller's. On the
CPU, ``make_mesh(n, "cpu")`` gives n shards ``cpu:0`` … ``cpu:n-1``, the
counterpart of JAX's virtual CPU devices: each gets its own replica, so the
CPU runs the replication path too.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass, field

import torch

AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D ``data`` mesh: the shards' devices, in order."""

    devices: tuple
    axis: str = AXIS
    _replicas: dict = field(default_factory=dict, compare=False, repr=False)

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """Where the batch lives before the split and after the gather."""
        return self.devices[0]

    def distinct(self) -> list:
        """The mesh's devices without repeats, in order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def replicate(self, module: torch.nn.Module) -> dict:
        """{device: module's copy there} for each distinct device, made once
        per module: the primary keeps the module itself (it lives there),
        every other device gets a copy."""
        key = id(module)
        if key not in self._replicas:
            self._replicas[key] = (module, {
                d: module if d == self.primary else copy.deepcopy(module).to(d)
                for d in self.distinct()})
        return self._replicas[key][1]


def make_mesh(n_devices: int | None = None, device: str | torch.device | None = "cuda",
              devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards: on ``cuda`` the first n visible cards
    (all of them for None), on ``cpu`` n CPU shards. ``devices``: an explicit
    list instead, repeats allowed (two shards on ``cuda:0``)."""
    if devices is not None:
        return Mesh(tuple(torch.device(d) for d in devices))
    kind = torch.device(device).type
    if kind == "cuda":
        n = torch.cuda.device_count() if n_devices is None else n_devices
        if n > torch.cuda.device_count():
            raise ValueError(f"make_mesh({n}): only {torch.cuda.device_count()} card(s) visible")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    if kind == "cpu":
        return Mesh(tuple(torch.device("cpu", i) for i in range(n_devices or 1)))
    raise NotImplementedError(f"make_mesh on {kind!r}: the mesh runs on 'cuda' or 'cpu'")


def visible_devices(device: torch.device, requested: int) -> int:
    """How many shards ``device``'s kind offers: the visible cards on
    ``cuda``; on the CPU the shards are virtual, as many as requested."""
    return torch.cuda.device_count() if device.type == "cuda" else requested


def clamp_mesh(n: int, visible: int) -> int:
    """``--mesh_devices n`` with ``visible`` devices: JAX's clamp
    (``engine/pipeline.py`` of the JAX package) to the visible count."""
    return min(n, visible)


def round_batch(frame_batch: int, n: int) -> int:
    """``--frame_batch`` rounded up to a multiple of the mesh size."""
    return -(-frame_batch // n) * n


def on_device(d: torch.device):
    """The context a shard's work is issued in: its card current on CUDA
    (the kernels launch on the current device's stream), nothing on the
    CPU."""
    return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()


def split(mesh: Mesh, x: torch.Tensor | None) -> list:
    """x's dim-0 chunks, one per shard, each on its shard's device
    (``non_blocking``); None stays None on every shard."""
    n = len(mesh)
    if x is None:
        return [None] * n
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the mesh size {n}")
    return [c.to(d, non_blocking=True) for c, d in zip(x.chunk(n, 0), mesh.devices)]


def gather(mesh: Mesh, chunks: list) -> torch.Tensor:
    """The shards' outputs concatenated in order on the primary device."""
    return torch.cat([c.to(mesh.primary, non_blocking=True) for c in chunks], 0)


def shard_stylizer(stylize_fns: dict, mesh: Mesh):
    """f(batch01) running ``stylize_fns[device](chunk)`` for each shard's
    chunk on its device, data-parallel: every shard's forward is issued
    from this thread before any output is gathered. ``stylize_fns`` maps
    each distinct device to the stylize function whose weights live there.
    The batch dim must be a multiple of the mesh size."""
    def run(batch01: torch.Tensor) -> torch.Tensor:
        outs = []
        for chunk, d in zip(split(mesh, batch01), mesh.devices):
            with on_device(d):
                outs.append(stylize_fns[d](chunk))
        return gather(mesh, outs)

    return run


def temporal_halo_exchange(mesh: Mesh, last_frames: list) -> list:
    """Shard k receives shard (k − 1) mod n's frame, on its own device: the
    ring JAX's ``ppermute`` with the permutation (i, (i + 1) mod n) forms."""
    n = len(mesh)
    return [last_frames[(k - 1) % n].to(mesh.devices[k], non_blocking=True) for k in range(n)]


def temporal_postprocess_sharded(mesh: Mesh, styled01: torch.Tensor, orig01: torch.Tensor,
                                 flows: torch.Tensor | None, *, state, first: bool,
                                 mask_alphas: torch.Tensor | None = None,
                                 mask_has: torch.Tensor | None = None, **chain_kwargs):
    """The temporal chain over a frame batch split in time across the mesh:
    each shard runs ``temporal_postprocess_split`` on its own chunk. Shard 0
    starts from ``state``, the sequential carry of the previous batch (the
    zero state on the first batch, with ``warmup=first``); shard k > 0
    starts from shard k − 1's last stylized frame and its LAB
    (``temporal_halo_exchange``), without warm-up: the raw boundary frame
    stands in for its smoothed version, an error that decays like
    (1 − alpha)^t into each chunk. ``flows`` must be computed for the whole
    batch (frame t − 1 → t, the boundary pairs included), so each seam warps
    with the true flow across it. The mask alphas and flags split with the
    frames.

    Returns (output on the primary device, the last shard's state moved to
    the primary: the carry for the next batch)."""
    from ..ops.color import rgb_to_lab_u8
    from ..temporal.ema import TemporalState, temporal_postprocess_split

    parts = [split(mesh, t) for t in (styled01, orig01, flows, mask_alphas, mask_has)]
    halos = temporal_halo_exchange(mesh, [s[-1] for s in parts[0]])
    outs, fstate = [], None
    for k, d in enumerate(mesh.devices):
        with on_device(d):
            if k == 0:
                init = TemporalState(*(t.to(d, non_blocking=True) for t in state))
                warmup = bool(first)
            else:
                init, warmup = TemporalState(halos[k], rgb_to_lab_u8(halos[k])), False
            out, fstate = temporal_postprocess_split(
                parts[0][k], parts[1][k], parts[2][k], init=init, warmup=warmup,
                mask_alphas=parts[3][k], mask_has=parts[4][k], **chain_kwargs)
            outs.append(out)
    carry = TemporalState(*(t.to(mesh.primary, non_blocking=True) for t in fstate))
    return gather(mesh, outs), carry
