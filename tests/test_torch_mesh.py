"""Port parity, the mesh slice: ``radiocapture_tpu_torch.parallel.mesh`` on
``torch.distributed`` against the JAX ``parallel/mesh.py`` on the same
inputs (the fixtures of ``test_pipeline_parallel.py``).

The port's ranks run in one 8-rank gloo world of CPU processes
(``mesh.spawn``; each rank runs ``torch_mesh_ranks.mesh_world``, every
check of the file in turn, so the world starts once). The JAX steps, on
the 8 virtual CPU devices of ``conftest.py``, and the port's unsharded
references run in this process."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as Pj

from radiocapture_tpu.frontend.pipeline import ControlPipeline as JPipe
from radiocapture_tpu.parallel import mesh as JMESH
from radiocapture_tpu.testing import modulators as M
from radiocapture_tpu_torch.demod import fsk4 as TK
from radiocapture_tpu_torch.demod import track_kernel as tk
from radiocapture_tpu_torch.entry import dryrun_multichip
from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
from radiocapture_tpu_torch.ops import fm as TFM
from radiocapture_tpu_torch.ops.fir import batched_fir
from radiocapture_tpu_torch.parallel import mesh as MESH
from test_pipeline_parallel import FS, _control_iq, _decode_slot
import torch_mesh_ranks

torch.set_num_threads(1)   # six test workers share the machine

REPO = Path(__file__).resolve().parent.parent

SLOTS = 8
OFFSET_HZ = 50e3
TS_BLOCKS = 3
# The pipeline's float32 tolerance (test_ops_channelizer.py:28), for the
# pre-scan stream of the signal lane against JAX: the port's wire bank
# builds its modulated taps with the phasor factorized, JAX's CPU path
# (call_wire falls back to __call__) with one sin/cos per tap.
PRESCAN_ATOL = 2e-3
# Noise lanes against JAX (the fixture's slots 1-7 hold only the -60 dB
# noise floor): XLA's conv and PyTorch's GEMM round the bank's sums apart
# by ~1e-7 of the in-band signal, which is ~1e-4 rad of the noise's
# phase; the discriminator scales that by its gain (6.6), and near a
# zero of |y| or atan2's ±π branch cut much more. Measured on this
# fixture: median 1.9e-4, 98.2-98.7% of samples within PRESCAN_ATOL (the
# signal lane within 1.5e-6). Held to this share of samples; the
# emit-mask check of test_torch_pipeline.py holds noise lanes to 0.95.
NOISE_PRESCAN_SHARE = 0.95
SY_DELTA = 0.15            # test_pipeline_parallel.py:173


def _wide(n_frames: int) -> np.ndarray:
    up = M.upsample_to(_control_iq(n_frames)[0], 25000.0, FS)
    return M.multi_channel(FS, [(OFFSET_HZ, up)], n=len(up))


def _grants(dib, val, slot=0) -> list:
    return [(t["Channel"], t["Group Address"])
            for t in _decode_slot(dib, val, slot)
            if t["name"] == "GRP_V_CH_GRANT"]


@pytest.fixture(scope="module")
def fx() -> dict:
    pipe = ControlPipeline.p25_c4fm(SLOTS, FS)
    bm = pipe.block_multiple
    dp = _wide(5)
    ts = _wide(6)
    bm2 = bm * 2                       # two time shards on 2 x 2 x 2
    rng = np.random.default_rng(3)
    offs = np.zeros(SLOTS, np.float32)
    offs[0] = OFFSET_HZ / FS
    return {"fs": FS, "slots": SLOTS, "offs": offs,
            "dp_wide": dp[:len(dp) // bm * bm],
            "ts_wide": ts, "ts_blocks": TS_BLOCKS,
            "ts_block": ((len(ts) // TS_BLOCKS) // bm2) * bm2,
            "fir_taps": np.hanning(33).astype(np.float32),
            "fir_x": rng.normal(size=2 * 256).astype(np.float32),
            "fir_xc": (rng.normal(size=2 * 256)
                       + 1j * rng.normal(size=2 * 256)).astype(np.complex64)}


@pytest.fixture(scope="module")
def world(fx) -> list:
    return MESH.spawn(8, torch_mesh_ranks.mesh_world, fx, device="cpu")


def _gather_outs(ranks: list, key, spec, lay) -> list:
    """The three (or four) outputs gathered over the ranks."""
    return [MESH.gather([key(r)[i] for r in ranks], spec, lay)
            for i in range(len(key(ranks[0])))]


def _ts_blocks(world) -> tuple:
    """The time-sharded outputs, gathered, block by block, and the
    layout."""
    lay = MESH.Layout(MESH.AXES3, tuple(world[0]["time"]["shape"]))
    spec = ("source", ("slot", "time"), None)
    return [_gather_outs(world, lambda r, b=b: r["time"]["blocks"][b], spec,
                         lay) for b in range(TS_BLOCKS)], lay


def _ts_inputs(fx):
    for i in range(TS_BLOCKS):
        b = fx["ts_block"]
        xb = fx["ts_wide"][i * b:(i + 1) * b]
        yield np.stack([xb.real, xb.imag], -1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_time(fx) -> dict:
    """JAX's time-sharded step_debug on make_mesh3(8) and its serial
    step_debug, block by block (test_pipeline_parallel.py:114-173)."""
    mesh = JMESH.make_mesh3(8)
    pipe = JPipe.p25_c4fm(num_slots=SLOTS, samp_rate=FS)
    n_src = mesh.shape["source"]
    tsh = JMESH.TimeShardedControlStep(pipe, mesh, n_sources=n_src)
    offs = jnp.broadcast_to(jnp.asarray(fx["offs"]), (n_src, SLOTS))
    st, ref_st = tsh.init(), pipe.init()
    sharded, serial = [], []
    for xf in _ts_inputs(fx):
        x = jnp.broadcast_to(jnp.asarray(xf), (n_src,) + xf.shape)
        st, o = tsh.step_debug(st, x, offs)
        ref_st, r = pipe.step_debug(ref_st, jnp.asarray(xf),
                                    jnp.asarray(fx["offs"]))
        sharded.append([np.asarray(v) for v in o])
        serial.append([np.asarray(v) for v in r])
    return {"sharded": sharded, "serial": serial}


@pytest.fixture(scope="module")
def port_serial(fx) -> dict:
    """The port's unsharded references on the time-sharded fixture, one
    source: ``ControlPipeline.step_debug`` (the wire bank), and the
    pre-scan stream from ``XlatBank.__call__`` (the complex bank the
    time-sharded step runs) with the pipeline's own discriminator and
    boxcar, tracked by ``track_stream``."""
    pipe = ControlPipeline.p25_c4fm(SLOTS, FS)
    offs = torch.from_numpy(fx["offs"])[None]
    st = pipe.init(1, "cpu")
    bank_st, quad = pipe.bank.init(1, "cpu"), TFM.quad_demod_init((1, SLOTS))
    sym_hist = torch.zeros((1, SLOTS, len(pipe.sym_taps) - 1))
    fsk4 = TK.fsk4_init((1, SLOTS))
    steps, exact = [], []
    for xf in _ts_inputs(fx):
        x = torch.from_numpy(xf)[None]
        st, o = pipe.step_debug(st, x, offs)
        steps.append([v.numpy() for v in o])
        bank_st, y = pipe.bank(bank_st, x, offs)
        quad, disc = TFM.quadrature_demod(quad, y, pipe.disc_gain)
        sym_hist, trk = batched_fir(sym_hist, disc, pipe.sym_taps,
                                    pipe.sym_decim)
        fsk4, syms, valid, dibits = tk.track_stream(trk, fsk4,
                                                    pipe.track_params)
        exact.append([v.numpy() for v in (syms, valid, dibits, trk)])
    return {"step": steps, "exact": exact}


@pytest.mark.parametrize("n", [1, 6, 8])
def test_mesh_shapes_match_jax(n):
    assert MESH.mesh_shape(n) == JMESH.make_mesh(n).devices.shape
    assert MESH.mesh3_shape(n) == JMESH.make_mesh3(n).devices.shape


def test_tile_gather_round_trip():
    """tile then gather gives the state back, (slot, time) lanes included;
    tiles of replicated leaves are equal on every rank that holds them."""
    lay = MESH.Layout(MESH.AXES3, (2, 2, 2))
    pipe = ControlPipeline.p25_c4fm(SLOTS, FS)
    gen = torch.Generator().manual_seed(0)
    state = pipe.init(4, "cpu")
    state = MESH._tree_map(
        lambda sp, t: torch.randn(t.shape, generator=gen).to(t.dtype),
        MESH.state_specs(), state)
    specs = MESH.state_specs("source", ("slot", "time"))
    tiles = [MESH.tile_state(state, specs, lay, lay.coords(r))
             for r in range(8)]
    assert tuple(tiles[5].fsk4.hist.shape) == (2, 2, TK.HIST)
    assert tuple(tiles[5].bank.history.shape) == (2, pipe.bank.ntaps - 1)
    torch.testing.assert_close(tiles[4].bank.history,
                               tiles[7].bank.history, rtol=0, atol=0)
    back = MESH.gather_state(tiles, specs, lay)
    same = MESH._tree_map(lambda sp, a, b: torch.equal(a, b), specs, back,
                          state)
    assert all(jax.tree.leaves(tuple(same)))


def test_dp_tp_matches_unsharded_and_jax(world, fx):
    """2 × 4 dp × tp: each source decodes, from its slot 0, the grants of
    the port's unsharded pipeline and of JAX's ``ShardedControlStep``;
    no collective (test_pipeline_parallel.py:71-111)."""
    lay = MESH.Layout(MESH.AXES, tuple(world[0]["dp_tp"]["shape"]))
    assert lay.shape == (2, 4)
    assert all(r["dp_tp"]["log"] == [] for r in world)
    syms, valid, dibits = _gather_outs(world, lambda r: r["dp_tp"]["outs"],
                                       ("source", "slot", None), lay)
    pipe = ControlPipeline.p25_c4fm(SLOTS, FS)
    block = len(fx["dp_wide"])
    assert syms.shape == (2, SLOTS, block // pipe.block_multiple)

    x1 = torch.from_numpy(fx["dp_wide"])[None]
    _, (_, rvalid, rdib) = pipe.step(pipe.init(1, "cpu"), x1,
                                     torch.from_numpy(fx["offs"])[None])
    ref = _grants([rdib[0].numpy()], [rvalid[0].numpy()])
    assert len(ref) >= 1

    jmesh = JMESH.make_mesh(8)
    jpipe = JPipe.p25_c4fm(num_slots=SLOTS, samp_rate=FS)
    jsh = JMESH.ShardedControlStep(jpipe, jmesh, n_sources=2)
    _, (_, jvalid, jdib) = jsh.step(
        jsh.init(), jnp.broadcast_to(jnp.asarray(fx["dp_wide"]), (2, block)),
        jnp.broadcast_to(jnp.asarray(fx["offs"]), (2, SLOTS)))
    for s in range(2):
        got = _grants([dibits[s]], [valid[s]])
        assert got == ref
        assert got == _grants([np.asarray(jdib[s])], [np.asarray(jvalid[s])])


def test_time_sharded_prescan_matches_serial(world, port_serial):
    """The 2 × 2 × 2 time-sharded step's pre-scan stream equals, bit for
    bit, the serial stream from the same ``XlatBank.__call__`` with the
    pipeline's discriminator and boxcar, three blocks in a row: the halo,
    the analytic uint32 phase, the all_to_all and the tail all_reduce
    leave no seam, and the plain bank computes each window the same
    whatever the block length (the claim JAX's test asserts,
    test_pipeline_parallel.py:144-157)."""
    blocks, _ = _ts_blocks(world)
    for b in range(TS_BLOCKS):
        trk, want = blocks[b][3], port_serial["exact"][b][3][0]
        assert trk.shape == (2,) + want.shape
        for s in range(2):
            np.testing.assert_array_equal(
                trk[s], want, err_msg=f"pre-scan seam at block {b} "
                f"source {s}")
        # the same stream through the same tracker: the same symbols
        np.testing.assert_array_equal(blocks[b][0][0],
                                      port_serial["exact"][b][0][0])


def test_time_sharded_matches_jax(world, jax_time, port_serial):
    """Against JAX's ``TimeShardedControlStep.step_debug``: the signal
    lane's pre-scan stream within PRESCAN_ATOL, the noise lanes' on
    NOISE_PRESCAN_SHARE of samples; the same grants as JAX's sharded and
    serial steps and the port's serial pipeline; symbols within SY_DELTA
    (rms) of the port's serial stream tracked the same way."""
    blocks, _ = _ts_blocks(world)
    dib, val, jdib, jval, rdib, rval = [], [], [], [], [], []
    sy_delta = []
    for b in range(TS_BLOCKS):
        syms, valid, dibits, trk = blocks[b]
        js, jv, jd, jt = jax_time["sharded"][b]
        np.testing.assert_allclose(trk[:, 0], jt[:, 0], rtol=0,
                                   atol=PRESCAN_ATOL)
        close = np.abs(trk - jt) <= PRESCAN_ATOL
        assert close.mean() >= NOISE_PRESCAN_SHARE, close.mean()
        dib.append(dibits[0])
        val.append(valid[0])
        jdib.append(jd[0])
        jval.append(jv[0])
        rdib.append(port_serial["step"][b][2][0])
        rval.append(port_serial["step"][b][1][0])
        sy_delta.append(np.sqrt(np.mean(
            (syms[0, 0] - port_serial["exact"][b][0][0, 0]) ** 2)))
    got = _grants(dib, val)
    assert len(got) >= 3
    assert got == _grants(jdib, jval)
    assert got == _grants(rdib, rval)
    assert got == _grants([s[2] for s in jax_time["serial"]],
                          [s[1] for s in jax_time["serial"]])
    assert max(sy_delta) < SY_DELTA, sy_delta


def test_time_sharded_collectives_match_formulas(world, fx):
    """Exactly the three collectives per step, at the per-device bytes of
    JAX's HLO for the same tile (test_pipeline_parallel.py:296-329): the
    halo send and the tail all_reduce S·halo·8, the all_to_all
    S·C·(N/n_t)·4; on the 2 × 2 × 2 world and on the formula test's
    tile (2 sources × 8 slots × 4 time shards on each rank)."""
    from jax.sharding import Mesh
    sys.path.insert(0, str(REPO / "tools"))
    from scaling_model import collective_inventory

    pipe = JPipe.p25_c4fm(num_slots=8, samp_rate=300e3)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 1, 4),
                ("source", "slot", "time"))
    s = JMESH.TimeShardedControlStep(pipe, mesh, 2)
    t = world[0]["formula"]["block"]
    hlo = s._step.lower(s.init(), np.zeros((2, t, 2), np.float32),
                        np.zeros((2, 8), np.float32)).compile().as_text()
    jgot = {}
    for e in collective_inventory(hlo):
        jgot[e["op"]] = jgot.get(e["op"], 0) + e["bytes"]
    nt = t // pipe.decim // pipe.sym_decim
    want = {"halo": 2 * s.halo * 8, "all_to_all": 2 * 8 * (nt // 4) * 4,
            "all_reduce": 2 * s.halo * 8}
    assert jgot == {"collective-permute": want["halo"],
                    "all-to-all": want["all_to_all"],
                    "all-reduce": want["all_reduce"]}
    for r in world:
        assert r["formula"]["halo"] == s.halo
        assert [(e["op"], e["bytes"]) for e in r["formula"]["log"]] == \
            list(want.items())

    tpipe = ControlPipeline.p25_c4fm(SLOTS, FS)
    nt = fx["ts_block"] // tpipe.decim // tpipe.sym_decim
    halo = world[0]["time"]["halo"]
    want = [("halo", halo * 8), ("all_to_all", (SLOTS // 2) * (nt // 2) * 4),
            ("all_reduce", halo * 8)] * TS_BLOCKS
    for r in world:
        assert [(e["op"], e["bytes"]) for e in r["time"]["log"]] == want
        assert all(e["axis"] == "time" for e in r["time"]["log"])


def test_time_sharded_fir_matches_convolve_and_jax(world, fx):
    """Overlap-save over the 't' axis of a 2 × 4 mesh, real and complex:
    np.convolve within 1e-5 and JAX's ``time_sharded_fir`` within 1e-5;
    one halo per call."""
    lay = MESH.Layout(("t", "u"), tuple(world[0]["fir"]["shape"]))
    assert lay.shape == (2, 4)
    taps = fx["fir_taps"]
    jmesh = JMESH.make_mesh(8, axis_names=("t", "u"))
    jf = JMESH.time_sharded_fir(jmesh, "t", jnp.asarray(taps))
    for i, key in enumerate(("fir_x", "fir_xc")):
        y = MESH.gather([r["fir"]["outs"][i] for r in world], ("t",), lay)
        x = fx[key]
        ref = np.convolve(np.concatenate([np.zeros(32, x.dtype), x]), taps,
                          mode="valid")
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
        jy = np.asarray(jf(jax.device_put(
            jnp.asarray(x), NamedSharding(jmesh, Pj("t")))))
        assert y.dtype == jy.dtype
        np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
    for r in world:
        assert [e["op"] for e in r["fir"]["log"]] == ["halo", "halo"]


def test_time_sharded_refuses_short_chunks(world):
    """A chunk shorter than the halo raises the JAX step's error on every
    rank, before any collective."""
    assert all("shorter than the halo" in r["short"] for r in world)


def test_step_debug_matches_jax(jax_time, port_serial):
    """``ControlPipeline.step_debug``: the port's pre-scan stream against
    JAX's on the signal lane within PRESCAN_ATOL (noise lanes on
    NOISE_PRESCAN_SHARE), and its step outputs are ``step``'s."""
    for b in range(TS_BLOCKS):
        got, want = port_serial["step"][b][3][0], jax_time["serial"][b][3]
        assert got.shape == want.shape
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=PRESCAN_ATOL)
        assert (np.abs(got - want) <= PRESCAN_ATOL).mean() >= \
            NOISE_PRESCAN_SHARE
    pipe = ControlPipeline.p25_c4fm(SLOTS, FS)
    x = torch.randn((2, pipe.block_multiple * 8, 2),
                    generator=torch.Generator().manual_seed(1))
    offs = torch.full((2, SLOTS), 0.01)
    _, a = pipe.step(pipe.init(2, "cpu"), x, offs)
    _, b = pipe.step_debug(pipe.init(2, "cpu"), x, offs)
    for u, v in zip(a, b[:3]):
        assert torch.equal(u, v)


def test_track_stream_plain_is_track_plain():
    """The stream tracker's plain version, on the pre-scan stream of bank
    planes, gives ``track_plain``'s outputs and state bit for bit."""
    pipe = ControlPipeline.p25_c4fm(SLOTS, FS)
    gen = torch.Generator().manual_seed(2)
    y_re, y_im = (torch.randn((2, 400, SLOTS), generator=gen)
                  for _ in range(2))
    st = pipe.init(2, "cpu")
    want = tk.track_plain(y_re, y_im, st.quad, st.sym_hist, st.fsk4,
                          pipe.track_params)
    trk = pipe.prescan(torch.complex(y_re, y_im).transpose(1, 2), st.quad,
                       st.sym_hist)
    got = tk.track_stream(trk, st.fsk4, pipe.track_params)
    for u, v in zip(got[1:], want[3:]):
        assert torch.equal(u, v)
    for u, v in zip(got[0], want[2]):
        assert torch.equal(u, v)


@pytest.mark.parametrize("n", [1, 6])
def test_dryrun_multichip_cpu(n):
    """The dry run on n gloo CPU ranks: both steps decode the grant on
    every source, the FIR holds, the logs hold (checked in the ranks)."""
    res = dryrun_multichip(n, device="cpu")
    assert res["mesh"] == list(MESH.mesh_shape(n))
    assert res["mesh3"] == list(MESH.mesh3_shape(n))
    assert res["backend"] == "gloo"
    src_ranks = [r for r in res["ranks"] if r["dp_tp_grants"]]
    assert len(src_ranks) == MESH.mesh_shape(n)[0]
    assert all(r["imported"] == [] for r in res["ranks"])
    assert all(r["time_launches"] == dict.fromkeys(r["time_launches"], 0)
               for r in res["ranks"])


def test_mesh_imports_no_jax(world):
    """Neither the mesh module nor a rank loads jax or the JAX package."""
    assert all(r["imported"] == [] for r in world)
    code = ("import sys; import radiocapture_tpu_torch.parallel.mesh, "
            "radiocapture_tpu_torch.entry; "
            "print([m for m in sys.modules if m == 'jax' or "
            "m.startswith('radiocapture_tpu.') or m == 'radiocapture_tpu'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300, cwd=REPO)
    assert out.stdout.strip() == "[]"
