"""Mesh sharding of the control pipeline over ``torch.distributed`` (port
of ``radiocapture_tpu.parallel.mesh``).

The JAX package runs one program over a ``jax.sharding.Mesh`` with
``shard_map``. Here each device of the mesh is a process, a rank, that
holds its own tile of the state and the inputs and calls the step on it.
The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
world's ranks, laid out row-major (rank r at ``np.unravel_index(r,
shape)``); each axis's process group is ``mesh.get_group(name)``. Its
axes:

- ``source``: data parallel over wideband sources (the reference's one
  process per dongle, rc_frontend/receiver.py:67-70);
- ``slot``: tensor parallel over the channel slots of each source;
- ``time`` (``make_mesh3``): sequence parallel over a block's samples,
  :class:`TimeShardedControlStep` and :func:`time_sharded_fir`.

Every collective goes through a :class:`Communicator`, which logs each
one as (op, axis, bytes per rank): the count that stands in for the JAX
package's HLO inventory (tools/scaling_model.py). :func:`spawn` starts
the ranks of a world; :func:`tile` and :func:`gather` cut a rank's tile
out of a full tensor and put the tiles back together, by the same specs
the JAX package writes as ``PartitionSpec``s.
"""

from __future__ import annotations

import math
import queue
import time
import traceback
from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from radiocapture_tpu_torch.demod import fsk4 as _fsk4
from radiocapture_tpu_torch.demod.track_kernel import track_stream
from radiocapture_tpu_torch.device import require_cuda
from radiocapture_tpu_torch.frontend.pipeline import (ControlPipeline,
                                                      ControlPipelineState,
                                                      _check_block)
from radiocapture_tpu_torch.ops import fm as _fm
from radiocapture_tpu_torch.ops.channelizer import XlatBank, XlatBankState
from radiocapture_tpu_torch.ops.fir import (U32_MASK, _conv1d, batched_fir,
                                            phase_step_u32)

AXES = ("source", "slot")
AXES3 = ("source", "slot", "time")
TIMEOUT_S = 600.0      # a rank's wait in a collective, and spawn's wait


# ---- the mesh ---------------------------------------------------------

def _divisor_at_most(n: int, r: int) -> int:
    """The largest divisor of n that is at most r (at least 1)."""
    return next((d for d in range(r, 0, -1) if n % d == 0), 1)


def mesh_shape(n: int) -> tuple[int, int]:
    """(sources, slots) of ``make_mesh(n)``: the source axis gets the
    largest factor ≤ √n, so both axes are populated when possible (the
    JAX ``make_mesh``, mesh.py:36-49)."""
    a = _divisor_at_most(n, int(np.sqrt(n)))
    return a, n // a


def mesh3_shape(n: int) -> tuple[int, int, int]:
    """(sources, slots, time) of ``make_mesh3(n)``: the cube root first,
    then the square root of the rest, the time axis last (the JAX
    ``make_mesh3``, mesh.py:130-152)."""
    a = _divisor_at_most(n, int(round(n ** (1.0 / 3.0))))
    rem = n // a
    b = _divisor_at_most(rem, int(np.sqrt(rem)))
    return a, b, rem // b


def device_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` over the whole world, ranks
    row-major, axes ``names``."""
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"a mesh of {math.prod(shape)} ranks in a world "
                         f"of {n}: the mesh spans the whole world")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_mesh(n_devices: int | None = None, axis_names: tuple = AXES):
    """A 2-D ``DeviceMesh`` (sources × slots, :func:`mesh_shape`) over the
    world's ranks; ``n_devices``, if given, must be the world size."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return device_mesh(mesh_shape(n), axis_names)


def make_mesh3(n_devices: int | None = None, axis_names: tuple = AXES3):
    """A 3-D ``DeviceMesh`` (sources × slots × time, :func:`mesh3_shape`)
    over the world's ranks."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return device_mesh(mesh3_shape(n), axis_names)


class Layout(NamedTuple):
    """A mesh's axis names and shape, ranks row-major."""
    names: tuple
    shape: tuple

    def size(self, axis) -> int:
        """Ranks along ``axis``: a name, or a tuple of names (one dimension
        split over their product, as the JAX spec entry ``(slot, time)``)."""
        if isinstance(axis, tuple):
            return math.prod(self.size(a) for a in axis)
        return self.shape[self.names.index(axis)]

    def index(self, axis, coords: dict) -> int:
        """The position along ``axis`` of the rank at ``coords``; for a
        tuple, row-major with the first name major."""
        if isinstance(axis, tuple):
            i = 0
            for a in axis:
                i = i * self.size(a) + coords[a]
            return i
        return coords[axis]

    def coords(self, rank: int) -> dict:
        return dict(zip(self.names, (int(v) for v in np.unravel_index(
            rank, self.shape))))


def layout_of(mesh) -> Layout:
    return Layout(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


# ---- tiles ------------------------------------------------------------

def tile(t: torch.Tensor, spec: tuple, lay: Layout,
         coords: dict) -> torch.Tensor:
    """The tile of the full tensor ``t`` that the rank at ``coords``
    holds: dimension i split evenly over the ranks along ``spec[i]``
    (``None``, or a dimension past the spec: whole). Contiguous."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = lay.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over {n} ranks along {axis}")
        w = t.shape[dim] // n
        t = t.narrow(dim, lay.index(axis, coords) * w, w)
    return t.contiguous()


def gather(tiles: list, spec: tuple, lay: Layout):
    """The full tensor from every rank's tile (``tiles`` by rank, tensors
    or numpy arrays), the inverse of :func:`tile`; of the ranks that hold
    the same tile (replicas along the axes the spec leaves out) the first
    one's is taken."""
    dims = [(d, a) for d, a in enumerate(spec) if a is not None]
    blocks: dict = {}
    for rank, t in enumerate(tiles):
        c = lay.coords(rank)
        blocks.setdefault(tuple(lay.index(a, c) for _, a in dims), t)
    numpy = isinstance(tiles[0], np.ndarray)

    def join(prefix: tuple):
        if len(prefix) == len(dims):
            return blocks[prefix]
        d, a = dims[len(prefix)]
        parts = [join(prefix + (i,)) for i in range(lay.size(a))]
        return np.concatenate(parts, d) if numpy else torch.cat(parts, d)
    return join(())


def _tree_map(fn, spec, *trees):
    if isinstance(trees[0], (torch.Tensor, np.ndarray)):
        return fn(spec, *trees)
    return type(trees[0])(*(_tree_map(fn, s, *ts)
                            for s, *ts in zip(spec, *trees)))


def tile_state(state, specs, lay: Layout, coords: dict):
    """:func:`tile` of every leaf of a state (nested NamedTuples) by the
    spec in the same place of ``specs``."""
    return _tree_map(lambda sp, t: tile(t, sp, lay, coords), specs, state)


def gather_state(tiles: list, specs, lay: Layout):
    """:func:`gather` of every leaf: the full state from the ranks'
    tiles (by rank)."""
    return _tree_map(lambda sp, *ts: gather(list(ts), sp, lay), specs,
                     *tiles)


def state_specs(src: str | None = "source", slot: str | None = "slot"
                ) -> ControlPipelineState:
    """The axes each leaf of a multi-source ``ControlPipelineState`` (xlat
    bank) is split over, dimension by dimension (the JAX ``state_specs``,
    mesh.py:52-69): the bank history by source, the mixer phase, the
    discriminator's previous sample, the boxcar history and the fsk4
    state by (source, slot)."""
    return ControlPipelineState(
        bank=XlatBankState(history=(src, None), phase=(src, slot)),
        quad=_fm.QuadDemodState(prev=(src, slot)),
        sym_hist=(src, slot, None),
        fsk4=_fsk4.Fsk4State(clock=(src, slot), fine_freq=(src, slot),
                             hist=(src, slot, None)))


# ---- collectives ------------------------------------------------------

class Communicator:
    """Makes every collective of the mesh steps, on the process groups of
    a ``DeviceMesh``'s axes, and logs each one in ``log`` as ``{"op",
    "axis", "bytes"}``: the bytes of the tensor this rank hands to it, as
    the JAX package's HLO inventory counts per device; ``"ms"`` too when
    ``timed`` (the device is synchronized before and after each one).

    It is the only place that knows the backend (:meth:`backend_for`):
    NCCL when every rank has a card of its own; gloo for CPU ranks and for
    several ranks that share one card, since NCCL refuses two ranks on one
    device. Gloo's send and receive take host memory only, so in a gloo
    world a CUDA operand is copied into pinned host memory, the collective
    runs there, and the result is copied back to the card; every
    collective is staged alike, so one rule holds and all the host
    traffic is counted. Each copy is logged as ``{"op": "host_staging",
    "of": op, ...}`` with its bytes. Only the operands move: the compute
    stays on the card."""

    STAGING = "host_staging"

    def __init__(self, mesh, timed: bool = False):
        self.mesh = mesh
        self.layout = layout_of(mesh)
        self.coords = self.layout.coords(dist.get_rank())
        self.timed = timed
        self.log: list[dict] = []

    @staticmethod
    def backend_for(world_size: int, device: torch.device) -> str:
        if device.type == "cuda" and world_size <= torch.cuda.device_count():
            return "nccl"
        return "gloo"

    def collectives(self) -> list[dict]:
        """The log without the staging copies."""
        return [e for e in self.log if e["op"] != self.STAGING]

    def staged_bytes(self) -> int:
        return sum(e["bytes"] for e in self.log if e["op"] == self.STAGING)

    def _group(self, axis: str):
        group = self.mesh.get_group(axis)
        return group, dist.get_process_group_ranks(group), self.coords[axis]

    def _begin(self, x: torch.Tensor) -> float:
        if self.timed and x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.perf_counter()

    def _end(self, op: str, axis: str, x: torch.Tensor, t0: float) -> None:
        entry = {"op": op, "axis": axis, "bytes": x.nbytes}
        if self.timed:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            entry["ms"] = (time.perf_counter() - t0) * 1e3
        self.log.append(entry)

    def _stages(self, x: torch.Tensor) -> bool:
        return x.is_cuda and dist.get_backend() == "gloo"

    def _host(self, x: torch.Tensor, op: str, axis: str,
              copy: bool = True) -> torch.Tensor:
        """x's operand for the backend: a contiguous copy in pinned host
        memory when staging (``copy``: with x's values), else x itself,
        contiguous."""
        if not self._stages(x):
            return x.contiguous()
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        if copy:
            h.copy_(x)
            self.log.append({"op": self.STAGING, "of": op, "axis": axis,
                             "bytes": h.nbytes})
        return h

    def _back(self, h: torch.Tensor, out: torch.Tensor, op: str,
              axis: str) -> torch.Tensor:
        if h is not out:
            out.copy_(h)
            self.log.append({"op": self.STAGING, "of": op, "axis": axis,
                             "bytes": h.nbytes})
        return out

    def halo(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """What the left neighbour along ``axis`` (index i-1) passed as x,
        of x's shape and dtype, and zeros at index 0 (``lax.ppermute``
        with the permutation i → i+1): each rank sends x to its right
        neighbour, the last to none."""
        t0 = self._begin(x)
        group, ranks, i = self._group(axis)
        out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        reqs, send, recv = [], None, None
        if i + 1 < len(ranks):
            send = self._host(x, "halo", axis)
            reqs.append(dist.isend(send, ranks[i + 1], group=group))
        if i > 0:
            recv = self._host(out, "halo", axis, copy=False)
            reqs.append(dist.irecv(recv, ranks[i - 1], group=group))
        for r in reqs:
            r.wait()
        if recv is not None:
            self._back(recv, out, "halo", axis)
        self._end("halo", axis, x, t0)
        return out

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x [n·k, ...]: part j of its n equal parts along dim 0 goes to
        the rank at index j along ``axis``; returns the n parts received,
        in index order along dim 0 (``all_to_all_single``)."""
        t0 = self._begin(x)
        group, _, _ = self._group(axis)
        send = self._host(x, "all_to_all", axis)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        recv = self._host(out, "all_to_all", axis, copy=False)
        dist.all_to_all_single(recv, send, group=group)
        self._back(recv, out, "all_to_all", axis)
        self._end("all_to_all", axis, x, t0)
        return out

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of x over the ranks along ``axis``, as a new contiguous
        tensor (x is not written)."""
        t0 = self._begin(x)
        group, _, _ = self._group(axis)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        buf = self._host(x, "all_reduce", axis) if self._stages(x) \
            else out.copy_(x)
        dist.all_reduce(buf, group=group)
        self._back(buf, out, "all_reduce", axis)
        self._end("all_reduce", axis, x, t0)
        return out


# ---- the ranks --------------------------------------------------------

def init_rank(rank: int, world_size: int, port: int,
              device=None) -> torch.device:
    """Join the process group as ``rank`` through the ``TCPStore`` that
    listens on 127.0.0.1:``port`` (:func:`spawn`'s) and return the device
    the rank computes on. ``device`` a CPU device: a CPU rank. Otherwise
    (``None`` included) a CUDA rank, rank r on card r mod the card count:
    its own card when there are enough, else sharing. The backend is
    :meth:`Communicator.backend_for`'s."""
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        require_cuda()
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    timeout = timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=timeout)
    dist.init_process_group(Communicator.backend_for(world_size, dev),
                            store=store, world_size=world_size, rank=rank,
                            timeout=timeout)
    return dev


def _rank_main(rank, world_size, port, device, fn, inbox, results):
    try:
        args = inbox.get(timeout=TIMEOUT_S)
        dev = init_rank(rank, world_size, port, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        results.put((rank, True, fn(dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(n: int, fn, *args, device=None) -> list:
    """Run ``fn(dev, *args)`` on ``n`` ranks and return the results by
    rank. Each rank is a process started by the ``spawn`` method (never
    fork: the caller may have CUDA up) that joins a process group
    through this process's store (:func:`init_rank`; ``device`` as
    there). ``fn`` must be a module-level function and return picklable
    values (numpy arrays, not tensors). A rank that raises, dies or
    outlives TIMEOUT_S fails the call; the others are ended.

    The rendezvous is a ``TCPStore`` this process opens on port 0 before
    any rank starts and keeps until they end: the port is bound from the
    moment it is chosen, so no other socket on the host can take it while
    the ranks import torch (a port found free, closed and bound again by
    rank 0 seconds later could be)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=TIMEOUT_S))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, store.port, device, fn, inbox,
                               results)) for r in range(n)]
    for p in procs:
        p.start()
    # the arguments go by queue: a process's own arguments are written
    # into its start-up pipe, which blocks the parent until that child
    # has imported its modules, one child after another
    for _ in procs:
        inbox.put(args)
    got: dict = {}
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while len(got) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n - len(got)} of {n} ranks gave "
                                       f"no result in {TIMEOUT_S:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(n)]


# ---- the steps --------------------------------------------------------

def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a·b mod 2^32 for an int64 tensor of uint32 values and an int b in
    [0, 2^32), in int64 (a·b itself can pass 2^63): b in 16-bit halves."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & U32_MASK) << 16)) & U32_MASK


class ShardedControlStep:
    """Multi-source, mesh-sharded control pipeline step (the JAX
    ``ShardedControlStep``, mesh.py:72-127). Each rank owns a (source
    subset × slot subset) tile: its sources' wideband blocks, its slots'
    offsets and their tracking state, and runs the port's batched
    ``ControlPipeline.step`` on it, so the dp×tp step runs no
    collective and ``comm.log`` stays empty. A rank calls :meth:`step`
    with its tiles (:meth:`shard` cuts them from the full inputs;
    :func:`gather` with ``out_spec`` puts the outputs back together).

    A tile holds C/slot_shards slots. The wire bank kernel computes slots
    in groups of 64 (``channelizer_kernel.SLOT_GROUP``), so a tile of 32
    or 4 slots costs the GEMM of 64."""

    def __init__(self, pipeline: ControlPipeline, mesh, n_sources: int):
        self.pipeline = pipeline
        self.mesh = mesh
        self.n_sources = n_sources
        self.layout = layout_of(mesh)
        self.coords = self.layout.coords(dist.get_rank())
        src, slot = self.layout.names
        self.specs = state_specs(src, slot)
        self.x_spec = (src,)                 # [S, T, 2] or [S, T]
        self.off_spec = (src, slot)
        self.out_spec = (src, slot, None)
        self.comm = Communicator(mesh)

    def init(self, device) -> ControlPipelineState:
        """This rank's tile of the all-zero state."""
        return tile_state(self.pipeline.init(self.n_sources, device),
                          self.specs, self.layout, self.coords)

    def shard(self, x: torch.Tensor, offsets_norm: torch.Tensor):
        """This rank's tiles of the full block [n_sources, T, ...] and the
        full offsets [n_sources, num_slots]."""
        return (tile(x, self.x_spec, self.layout, self.coords),
                tile(offsets_norm, self.off_spec, self.layout, self.coords))

    def step(self, state: ControlPipelineState, x: torch.Tensor,
             offsets_norm: torch.Tensor):
        """x: this rank's [S_l, T, 2] wire block (or [S_l, T] complex64);
        offsets_norm [S_l, C_l] → (state, (syms, valid, dibits)
        [S_l, C_l, T // block_multiple])."""
        return self.pipeline.step(state, x, offsets_norm)


class TimeState(NamedTuple):
    in_hist: torch.Tensor       # [S, halo] complex64: the block-end tail
    phase: torch.Tensor         # [S, C] int64: uint32 mixer phase
    fsk4: _fsk4.Fsk4State       # batch [S, C]


class TimeShardedControlStep:
    """dp × tp × sequence-parallel control pipeline step (the JAX
    ``TimeShardedControlStep``, mesh.py:155-336).

    A block's time axis is split over the ``time`` ranks. Each channelizes
    its chunk after taking a halo of ``(K-1) + D·c_ctx`` samples from its
    left neighbour (the block-end tail carried in the state for the first
    chunk), with the mixer's uint32 phase moved analytically to its
    chunk's first output; it discriminates and boxcar-filters in plain
    torch as the JAX step does (mesh.py:299-308). One ``all_to_all`` over
    the time group then splits the slots and joins the time, so each rank
    tracks the whole block for C/(slot_shards·time_shards) lanes
    (``track_kernel.track_stream``); an ``all_reduce`` carries the block's
    tail to every rank of the group for the next block.

    The bank is ``XlatBank.__call__``, the float32 complex bank, batched
    over the rank's sources (on the card ``csrc/xlat_complex.cu``'s
    general path). Contract as :class:`ShardedControlStep`'s, on this
    rank's tiles: x [S_l, T/time_shards, 2], offsets [S_l, C_l] →
    outputs [S_l, C_l/time_shards, T // block_multiple]. T must be a
    multiple of time_shards × block_multiple, C of slot_shards ×
    time_shards, and each chunk at least the halo long."""

    def __init__(self, pipeline: ControlPipeline, mesh, n_sources: int):
        bank = pipeline.bank
        if not isinstance(bank, XlatBank):
            raise ValueError("time sharding requires the xlat frontend")
        self.pipeline = pipeline
        self.mesh = mesh
        self.n_sources = n_sources
        self.layout = layout_of(mesh)
        self.coords = self.layout.coords(dist.get_rank())
        self.ax_src, self.ax_slot, self.ax_time = self.layout.names
        # left context for exact streaming equivalence: K-1 input samples
        # for the xlat window plus sym_ntaps channel-rate samples (one for
        # the discriminator's previous sample, sym_ntaps-1 for the boxcar)
        self.c_ctx = len(pipeline.sym_taps)
        self.halo = (bank.ntaps - 1) + bank.decim * self.c_ctx
        src, slot, time_ = self.layout.names
        lanes = (slot, time_)
        self.specs = TimeState(
            in_hist=(src, None), phase=(src, slot),
            fsk4=_fsk4.Fsk4State(clock=(src, lanes), fine_freq=(src, lanes),
                                 hist=(src, lanes, None)))
        self.x_spec = (src, time_)
        self.off_spec = (src, slot)
        self.out_spec = (src, lanes, None)
        self.comm = Communicator(mesh)

    def init(self, device) -> TimeState:
        """This rank's tile of the all-zero state."""
        s, c = self.n_sources, self.pipeline.num_slots
        full = TimeState(
            in_hist=torch.zeros((s, self.halo), dtype=torch.complex64,
                                device=device),
            phase=torch.zeros((s, c), dtype=torch.int64, device=device),
            fsk4=_fsk4.fsk4_init((s, c), device))
        return tile_state(full, self.specs, self.layout, self.coords)

    def shard(self, x: torch.Tensor, offsets_norm: torch.Tensor):
        """This rank's tiles of the full block [n_sources, T, 2] and the
        full offsets [n_sources, num_slots]."""
        return (tile(x, self.x_spec, self.layout, self.coords),
                tile(offsets_norm, self.off_spec, self.layout, self.coords))

    def step(self, state: TimeState, x: torch.Tensor,
             offsets_norm: torch.Tensor):
        """→ (state, (syms, valid, dibits)) on this rank's tiles."""
        return self._local(state, x, offsets_norm, with_track=False)

    def step_debug(self, state: TimeState, x: torch.Tensor,
                   offsets_norm: torch.Tensor):
        """:meth:`step` with a 4th output: this rank's pre-scan track-rate
        stream [S_l, C_l/time_shards, T // block_multiple] after the
        all_to_all, the stream the tracker reads."""
        return self._local(state, x, offsets_norm, with_track=True)

    def _lanes(self, trk: torch.Tensor) -> torch.Tensor:
        """[S, C_l, N_l] (all slots, this chunk) → [S, C_l/n, n·N_l] (a
        1/n of the slots, the whole block) over the time group: the JAX
        ``all_to_all(split_axis=1, concat_axis=2, tiled=True)``.
        ``all_to_all_single`` splits dim 0, so the slots go first."""
        n = self.layout.size(self.ax_time)
        s, c, m = trk.shape
        if c % n:
            raise ValueError(f"{c} slots of a slot shard do not split over "
                             f"{n} time shards")
        send = trk.permute(1, 0, 2).reshape(n, c // n, s, m)
        got = self.comm.all_to_all(send, self.ax_time)   # part i: time i
        return got.permute(2, 1, 0, 3).reshape(s, c // n, n * m).contiguous()

    def _local(self, state: TimeState, x: torch.Tensor,
               offsets_norm: torch.Tensor, with_track: bool):
        pipe, bank = self.pipeline, self.pipeline.bank
        d, k, h, c_ctx = bank.decim, bank.ntaps, self.halo, self.c_ctx
        n_time = self.layout.size(self.ax_time)
        t_idx = self.coords[self.ax_time]
        if x.is_complex():
            x = torch.view_as_real(x.to(torch.complex64))
        if x.shape[1] < h:
            raise ValueError(
                f"time-shard chunk ({x.shape[1]} samples) shorter than "
                f"the halo ({h}): the immediate-left-neighbor exchange "
                f"needs T >= time_shards * halo samples per block")
        _check_block(x, pipe.block_multiple)
        n_l = x.shape[1] // d
        # halo: my last h inputs go right; the first chunk takes the
        # block-end tail carried in the state
        tail = x[:, x.shape[1] - h:].to(torch.float32)       # [S, h, 2]
        left = self.comm.halo(tail, self.ax_time)
        ctx = state.in_hist if t_idx == 0 else torch.view_as_complex(left)
        # the mixer phase of this chunk's first output, output t·n_l -
        # c_ctx of the block (uint32 wraps)
        step = phase_step_u32(offsets_norm, d)                # [S, C_l]
        phase0 = (state.phase + _mul_u32(
            step, (n_l * t_idx - c_ctx) % 2 ** 32)) & U32_MASK
        zx = torch.cat([torch.view_as_real(ctx[:, k - 1:]),
                        x.to(torch.float32)], dim=1)
        _, y = bank(XlatBankState(history=ctx[:, :k - 1].contiguous(),
                                  phase=phase0), zx, offsets_norm)
        # discriminator over the extended run, then the boxcar at the
        # streaming pipeline's stride phase (n_l % sym_decim == 0)
        _, disc = _fm.quadrature_demod(_fm.QuadDemodState(prev=y[..., 0]),
                                       y[..., 1:], pipe.disc_gain)
        nt = len(pipe.sym_taps)
        _, trk = batched_fir(disc[..., :nt - 1], disc[..., nt - 1:],
                             pipe.sym_taps, pipe.sym_decim)   # [S, C_l, N_l]
        trk = self._lanes(trk)
        fs, syms, valid, dibits = track_stream(trk, state.fsk4,
                                               pipe.track_params)
        # the block's tail lives on the last chunk; the sum over the
        # group gives it to every rank
        own = tail if t_idx == n_time - 1 else torch.zeros_like(tail)
        hist = self.comm.all_reduce(own, self.ax_time)
        new_state = TimeState(
            in_hist=torch.view_as_complex(hist),
            phase=(state.phase + _mul_u32(step, n_l * n_time)) & U32_MASK,
            fsk4=fs)
        outs = (syms, valid, dibits)
        return new_state, (outs + (trk,) if with_track else outs)


def time_sharded_fir(mesh, axis: str, taps, decim: int = 1):
    """Overlap-save FIR with a block's time axis split over ``axis`` (the
    JAX ``time_sharded_fir``, mesh.py:339-376). Returns ``f(x)`` for this
    rank's chunk x [T_l] (real or complex): it takes its K-1-sample left
    halo from the previous rank (zeros into the first: a causal start),
    runs a valid correlation with the reversed taps (``ops.fir``'s
    ``conv1d``) and returns its [T_l // decim] outputs, float32 or
    complex64. ``f.comm`` holds the log."""
    k = len(taps)
    comm = Communicator(mesh)

    def f(x: torch.Tensor) -> torch.Tensor:
        h = torch.as_tensor(np.asarray(taps, np.float32), device=x.device)
        if k > 1:
            if x.shape[0] < k - 1:
                raise ValueError(f"chunk of {x.shape[0]} samples shorter "
                                 f"than the {k - 1}-sample halo")
            edge = x[x.shape[0] - (k - 1):]
            if x.is_complex():
                left = torch.view_as_complex(comm.halo(
                    torch.view_as_real(edge.to(torch.complex64)), axis))
            else:
                left = comm.halo(edge, axis)
            x = torch.cat([left, x.to(left.dtype)])
        return _conv1d(x, h, decim)

    f.comm = comm
    return f
