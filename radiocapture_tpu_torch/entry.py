"""Entry points: the flagship step of the port, ready to call, and the
multi-rank dry run.

``entry(device)`` mirrors the JAX package's ``__graft_entry__.entry()``:
the P25 control-channel capture pipeline (xlat bank → discriminator →
boxcar → fsk4 tracking → slicer) for 64 channel slots of one 2.4 MS/s
source, its zero state, one bf16 wire block and the slot offsets.

``dryrun_multichip(n, device)`` mirrors ``__graft_entry__.
dryrun_multichip(n)``: on n ranks (``parallel.mesh.spawn``) it decodes a
P25 grant through the dp×tp ``ShardedControlStep``, runs the
time-sharded FIR and decodes the grant through the dp×tp×time
``TimeShardedControlStep``, and checks each step's collectives.
"""

from __future__ import annotations

import numpy as np
import torch

from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
from radiocapture_tpu_torch.utils import trace

SAMP_RATE = 2.4e6
NUM_SLOTS = 64


def entry(device):
    """Returns ``(fn, (state, x, offsets))``; ``fn(*args)`` runs one step
    and returns ``(state, (symbols, valid, dibits))``."""
    pipe = ControlPipeline.p25_c4fm(num_slots=NUM_SLOTS, samp_rate=SAMP_RATE)
    state = pipe.init(1, device)
    block = pipe.decim * 512
    rng = np.random.default_rng(0)
    x = wire_from_numpy(rng.standard_normal((1, block, 2))
                        .astype(np.float32), device).to(torch.bfloat16)
    offsets = torch.as_tensor(
        ((np.arange(NUM_SLOTS) - NUM_SLOTS // 2) * 25e3 / SAMP_RATE)
        .astype(np.float32)[None], device=device)
    return pipe.step, (state, x, offsets)


DRYRUN_RATE = 400e3         # the JAX dry run's wideband rate
DRYRUN_OFFSET = 50e3        # its control channel's offset
DRYRUN_GRANT = {"Channel": 0x1234, "Group Address": 500,
                "Source Address": 42}


def grant_capture(samp_rate: float = DRYRUN_RATE) -> np.ndarray:
    """The JAX dry run's fixture (``__graft_entry__.py:69-80``): five TSDU
    frames of one GRP_V_CH_GRANT, C4FM at 25 kS/s, upsampled and placed
    at +50 kHz in a ``samp_rate`` capture, complex64."""
    from radiocapture_tpu_torch.fec import bits
    from radiocapture_tpu_torch.protocol import p25
    from radiocapture_tpu_torch.testing import modulators as M
    frame = p25.build_tsdu_frame(0x293, [p25.pack_tsbk(
        "GRP_V_CH_GRANT", last_block=True, **DRYRUN_GRANT)])
    chan = M.c4fm_modulate(bits.bits_to_dibits(np.concatenate([frame] * 5)),
                           fs=25000.0)
    up = M.upsample_to(chan, 25000.0, samp_rate)
    return M.multi_channel(samp_rate, [(DRYRUN_OFFSET, up)], n=len(up))


_KERNELS = ("bank_operands", "xlat_bank", "fsk_track", "xlat_complex",
            "fsk_track_stream")


def _launches() -> dict:
    return {k: trace.counter(f"launch.{k}") for k in _KERNELS}


def _reset_launches() -> None:
    trace.reset("launch.")


def _grants_of(dibs: list, vals: list, src: int, slot: int) -> list:
    from radiocapture_tpu_torch.testing import streams
    d = np.concatenate([b[src, slot] for b in dibs])
    v = np.concatenate([b[src, slot] for b in vals]).astype(bool)
    return streams.grants(d[v])


def _wire_blocks(wide: np.ndarray, block: int, n_sources: int):
    """float32 [n_sources, block, 2] blocks of ``wide``, every source the
    same capture."""
    for i in range(len(wide) // block):
        xb = wide[i * block:(i + 1) * block]
        xf = torch.from_numpy(np.stack([xb.real, xb.imag], -1).astype(
            np.float32))
        yield xf.expand(n_sources, block, 2)


def _check_grants(got: list, what: str) -> int:
    want = (DRYRUN_GRANT["Channel"], DRYRUN_GRANT["Group Address"],
            DRYRUN_GRANT["Source Address"])
    if not got or got[0] != want:
        raise AssertionError(f"{what}: decoded {got}, want {want} first")
    return len(got)


def time_shard_formulas(tsh, n_sources_local: int, block: int) -> dict:
    """Bytes per rank of the time-sharded step's three collectives, as
    ``tests/test_pipeline_parallel.py:320-328`` writes them for the JAX
    step's HLO: the halo send and the tail all_reduce, [S_l, halo]
    complex64; the all_to_all, the [S_l, C_l, N_l] float32 track-rate
    stream of one chunk."""
    pipe = tsh.pipeline
    n_t = tsh.layout.size(tsh.ax_time)
    c_l = pipe.num_slots // tsh.layout.size(tsh.ax_slot)
    nt = block // pipe.decim // pipe.sym_decim
    return {"halo": n_sources_local * tsh.halo * 8,
            "all_to_all": n_sources_local * c_l * (nt // n_t) * 4,
            "all_reduce": n_sources_local * tsh.halo * 8}


def check_time_log(tsh, n_sources_local: int, block: int,
                   steps: int) -> dict:
    """Holds the time-sharded step's log to exactly one halo, one
    all_to_all and one all_reduce per step, each at
    :func:`time_shard_formulas`' bytes. Returns the formulas."""
    want = time_shard_formulas(tsh, n_sources_local, block)
    got = [(e["op"], e["bytes"]) for e in tsh.comm.collectives()]
    if got != list(want.items()) * steps:
        raise AssertionError(f"time-sharded collectives {got}, want "
                             f"{list(want.items())} per step × {steps}")
    return want


def _dryrun_rank(dev) -> dict:
    import sys

    import torch.distributed as dist

    from radiocapture_tpu_torch.parallel import mesh as MESH
    rank, n = dist.get_rank(), dist.get_world_size()
    wide = grant_capture()
    res = {"rank": rank, "device": str(dev), "backend": dist.get_backend()}

    # dp x tp: sources over ranks, slots over ranks, no collective
    mesh = MESH.make_mesh(n)
    n_src, n_slot = MESH.layout_of(mesh).shape
    # the slot count must split over the slot axis (2 x 3 at n = 6)
    num_slots = n_slot * max(2, -(-8 // n_slot))
    pipe = ControlPipeline.p25_c4fm(num_slots, DRYRUN_RATE)
    sh = MESH.ShardedControlStep(pipe, mesh, n_src)
    offs = np.zeros((n_src, num_slots), np.float32)
    offs[:, 0] = DRYRUN_OFFSET / DRYRUN_RATE
    state = sh.init(dev)
    _reset_launches()
    dibs, vals = [], []
    for xf in _wire_blocks(wide, pipe.block_multiple * 32, n_src):
        x, o = sh.shard(xf, torch.from_numpy(offs))
        state, (syms, valid, dibits) = sh.step(state, x.to(dev), o.to(dev))
        dibs.append(dibits.cpu().numpy())
        vals.append(valid.cpu().numpy())
    res["dp_tp_launches"] = _launches()
    res["dp_tp_shape"] = list(syms.shape)
    if sh.comm.log:
        raise AssertionError(f"dp x tp step ran collectives {sh.comm.log}")
    res["dp_tp_grants"] = [
        _check_grants(_grants_of(dibs, vals, s, 0), f"dp x tp source {s}")
        for s in range(syms.shape[0])] if sh.coords["slot"] == 0 else []

    # the overlap-save FIR, time over the source axis
    taps = np.hanning(17).astype(np.float32)
    fir = MESH.time_sharded_fir(mesh, "source", taps)
    xt = torch.arange(n_src * 128, dtype=torch.float32)
    y = fir(MESH.tile(xt, ("source",), sh.layout, sh.coords).to(dev))
    ref = np.convolve(np.concatenate([np.zeros(16, np.float32), xt.numpy()]),
                      taps, mode="valid")
    want = MESH.tile(torch.from_numpy(ref), ("source",), sh.layout,
                     sh.coords).numpy()
    res["fir_max_abs_err"] = float(np.abs(y.cpu().numpy() - want).max())
    if not np.allclose(y.cpu().numpy(), want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"time-sharded FIR off by "
                             f"{res['fir_max_abs_err']}")
    res["fir_log"] = fir.comm.collectives()

    # dp x tp x time: halo, all_to_all, all_reduce
    mesh3 = MESH.make_mesh3(n)
    lay3 = MESH.layout_of(mesh3)
    n_src3 = lay3.size("source")
    lane = lay3.size(("slot", "time"))
    pipe3 = ControlPipeline.p25_c4fm(lane * max(2, -(-8 // lane)),
                                     DRYRUN_RATE)
    tsh = MESH.TimeShardedControlStep(pipe3, mesh3, n_src3)
    blk3 = pipe3.block_multiple * lay3.size("time") * 64
    offs3 = np.zeros((n_src3, pipe3.num_slots), np.float32)
    offs3[:, 0] = DRYRUN_OFFSET / DRYRUN_RATE
    st3 = tsh.init(dev)
    _reset_launches()
    dibs3, vals3 = [], []
    for xf in _wire_blocks(wide, blk3, n_src3):
        x, o = tsh.shard(xf, torch.from_numpy(offs3))
        st3, (syms, valid, dibits) = tsh.step(st3, x.to(dev), o.to(dev))
        dibs3.append(dibits.cpu().numpy())
        vals3.append(valid.cpu().numpy())
    res["time_launches"] = _launches()
    res["time_shape"] = list(syms.shape)
    res["time_steps"] = len(dibs3)
    res["time_bytes"] = check_time_log(tsh, syms.shape[0], blk3,
                                       len(dibs3))
    res["time_log"] = tsh.comm.log
    res["time_staged_bytes"] = tsh.comm.staged_bytes()
    first = lay3.index(("slot", "time"), tsh.coords) == 0
    res["time_grants"] = [
        _check_grants(_grants_of(dibs3, vals3, s, 0), f"time-sharded "
                      f"source {s}") for s in range(syms.shape[0])] \
        if first else []
    res["mesh"], res["mesh3"] = list(sh.layout.shape), list(lay3.shape)
    res["imported"] = [m for m in ("jax", "radiocapture_tpu")
                       if m in sys.modules]
    return res


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The multi-rank dry run (``__graft_entry__.dryrun_multichip``,
    :37-162) on ``n_devices`` ranks started by ``parallel.mesh.spawn``:
    ``device="cpu"`` gloo CPU ranks; ``None`` CUDA ranks (NCCL when each
    has a card of its own, else gloo on the shared card).

    Each rank decodes the P25 grant at +50 kHz through
    ``ShardedControlStep`` on ``make_mesh(n)`` (its log must stay empty),
    runs ``time_sharded_fir`` against ``np.convolve``, and decodes the
    grant through ``TimeShardedControlStep`` on ``make_mesh3(n)`` (one
    halo, one all_to_all and one all_reduce per step, at the JAX
    formulas' bytes). Raises on any failure; returns a summary: the mesh
    shapes, the backend, each rank's results, the kernels' launches
    summed over the ranks for each step."""
    from radiocapture_tpu_torch.parallel import mesh as MESH
    ranks = MESH.spawn(n_devices, _dryrun_rank, device=device)
    if not any(r["dp_tp_grants"] for r in ranks) or not any(
            r["time_grants"] for r in ranks):
        raise AssertionError("no rank decoded the grant")
    return {"world": n_devices, "backend": ranks[0]["backend"],
            "mesh": ranks[0]["mesh"], "mesh3": ranks[0]["mesh3"],
            "launches": {k: {name: sum(r[k][name] for r in ranks)
                             for name in ranks[0][k]}
                         for k in ("dp_tp_launches", "time_launches")},
            "ranks": ranks}
