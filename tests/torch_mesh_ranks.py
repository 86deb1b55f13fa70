"""What each rank of ``test_torch_mesh.py``'s 8-rank gloo world runs (a
module of its own, so the spawned ranks import torch and the port only,
never JAX or the test file). Results go back as numpy arrays."""

import numpy as np
import torch

from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
from radiocapture_tpu_torch.parallel import mesh as MESH


def _np(outs) -> list:
    return [o.cpu().numpy() for o in outs]


def _wire(wide: np.ndarray, n_sources: int) -> torch.Tensor:
    """[T] complex64 → [n_sources, T, 2] float32, each source the same."""
    xf = np.stack([wide.real, wide.imag], -1).astype(np.float32)
    return torch.from_numpy(xf).expand(n_sources, -1, 2)


def dp_tp(dev, fx: dict) -> dict:
    """``ShardedControlStep`` on ``make_mesh()`` (2 × 4): one step over
    the whole fixture, complex64 blocks (the JAX test's call)."""
    mesh = MESH.make_mesh()
    pipe = ControlPipeline.p25_c4fm(fx["slots"], fx["fs"])
    n_src = MESH.layout_of(mesh).size("source")
    sh = MESH.ShardedControlStep(pipe, mesh, n_src)
    x = torch.from_numpy(fx["dp_wide"]).expand(n_src, -1)
    offs = torch.from_numpy(np.tile(fx["offs"], (n_src, 1)))
    xl, ol = sh.shard(x, offs)
    _, outs = sh.step(sh.init(dev), xl.to(dev), ol.to(dev))
    return {"shape": list(sh.layout.shape), "outs": _np(outs),
            "log": list(sh.comm.log)}


def time_sharded(dev, fx: dict) -> dict:
    """``TimeShardedControlStep.step_debug`` on ``make_mesh3()``
    (2 × 2 × 2) over three float32 wire blocks."""
    mesh = MESH.make_mesh3()
    pipe = ControlPipeline.p25_c4fm(fx["slots"], fx["fs"])
    n_src = MESH.layout_of(mesh).size("source")
    tsh = MESH.TimeShardedControlStep(pipe, mesh, n_src)
    offs = torch.from_numpy(np.tile(fx["offs"], (n_src, 1)))
    st = tsh.init(dev)
    blocks = []
    for i in range(fx["ts_blocks"]):
        b = fx["ts_block"]
        x = _wire(fx["ts_wide"][i * b:(i + 1) * b], n_src)
        xl, ol = tsh.shard(x, offs)
        st, outs = tsh.step_debug(st, xl.to(dev), ol.to(dev))
        blocks.append(_np(outs))
    return {"shape": list(tsh.layout.shape), "blocks": blocks,
            "log": list(tsh.comm.log), "halo": tsh.halo}


def formula_step(dev, fx: dict) -> dict:
    """One time-sharded step on a 2 × 1 × 4 mesh with 4 sources, so each
    rank holds the JAX formula test's 2 sources × 8 slots × 4 time
    shards (test_pipeline_parallel.py:296-329): its log, per rank."""
    mesh = MESH.device_mesh((2, 1, 4), MESH.AXES3)
    pipe = ControlPipeline.p25_c4fm(8, 300e3)
    tsh = MESH.TimeShardedControlStep(pipe, mesh, 4)
    bm = pipe.block_multiple
    t = 4 * bm * max(1, -(-tsh.halo // bm)) * 4
    x = torch.zeros((4, t, 2))
    xl, ol = tsh.shard(x, torch.zeros((4, 8)))
    tsh.step(tsh.init(dev), xl.to(dev), ol.to(dev))
    return {"log": tsh.comm.collectives(), "block": t, "halo": tsh.halo}


def fir(dev, fx: dict) -> dict:
    """``time_sharded_fir`` over the 't' axis of ``make_mesh(8, ('t',
    'u'))`` on a real and a complex block."""
    mesh = MESH.make_mesh(8, axis_names=("t", "u"))
    lay = MESH.layout_of(mesh)
    coords = lay.coords(torch.distributed.get_rank())
    f = MESH.time_sharded_fir(mesh, "t", fx["fir_taps"])
    outs = [f(MESH.tile(torch.from_numpy(fx[k]), ("t",), lay, coords).to(
        dev)).cpu().numpy() for k in ("fir_x", "fir_xc")]
    return {"shape": list(lay.shape), "outs": outs,
            "log": f.comm.collectives()}


def short_chunk(dev) -> str:
    """A time-sharded step on chunks shorter than the halo: the error."""
    mesh = MESH.make_mesh3()
    pipe = ControlPipeline.p25_c4fm(8, 300e3)
    tsh = MESH.TimeShardedControlStep(pipe, mesh, 2)
    try:
        tsh.step(tsh.init(dev), torch.zeros((1, pipe.block_multiple, 2),
                                            device=dev),
                 torch.zeros((1, 4), device=dev))
    except ValueError as e:
        return str(e)
    return "no error"


def mesh_world(dev, fx: dict) -> dict:
    """Every check of the 8-rank world, one after the other."""
    import sys
    return {"rank": torch.distributed.get_rank(),
            "dp_tp": dp_tp(dev, fx), "time": time_sharded(dev, fx),
            "formula": formula_step(dev, fx), "fir": fir(dev, fx),
            "short": short_chunk(dev),
            "imported": [m for m in ("jax", "radiocapture_tpu")
                         if m in sys.modules]}
