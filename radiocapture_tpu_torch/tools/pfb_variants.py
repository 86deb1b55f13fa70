"""Time builds of the pfb coarse kernel's ``pfb_bins`` entry
(``csrc/pfb_rows.cu``) with a part of its epilogue changed or its plan
overridden, against the unchanged build of the same source, on one CUDA
card at the cases of ``chip_smoke.py``'s ``pfb bins kernel:`` line: M = 6
at the bench shape (128 sources × 240,000 bf16 samples), and the pfb
mode's 80 dB banks at M · 400 kHz, 16 sources × 100 ms (M = 8 complex64,
16 float32, 20, 25 and 50 bf16, 100 float32), from a random history.

``--source FILE`` varies another source than the package's: one whose
``pfb_bins_launch`` has no M1, M2 arguments (``pfb_rows_ef6af1a.cu``
beside this module, the kernel as commit ef6af1a had it) is driven with
the direct table and that commit's plan. ``--m 6,25,100`` picks the cases (these three by
default).

Each variant rewrites a copy of the source (``a+b`` applies both):

- ``cb=N``: N channels a thread on the direct path (even; the package's
  8; ``cb=6`` pads no channel at M = 6);
- ``f_unroll=N``: the factored epilogue's loop over a stage's outputs
  unrolled N times (at least the factor: whole);
- ``ksmall=N``: K_SMALL = N rows a lane (odd; with ``k=N`` the plan
  takes it, on either wire);

and, wrong on purpose, to show what one part of the work costs:

- ``stores_only``: the direct epilogue's stores without the table
  product (zeros stored);
- ``product_only``: the direct epilogue's product without its stores (a
  store that never fires on these data, so the compiler keeps the work);
- ``f_stores_only``, ``f_product_only``: the same for the factored
  epilogue, both stages (without the products the first stage writes
  zeros back over the planes; without the stores the second reads the
  sums themselves);
- ``no_epilogue``: neither the product nor the stores, on either path:
  the staging, the sums and the rounds alone;

or overrides the plan, with the source unchanged (a source with M1, M2
only):

- ``direct``: the direct table at any M;
- ``factors=AxB``: the IDFT factored as M1 = A, M2 = B;
- ``k=N``: N rows a lane (the wire's K or K_SMALL);
- ``kwire``: commit ef6af1a's plan (``track_turns.ef6af1a_plan``: the
  wire's K unless it does not fit, ⌈M/16⌉ rounds of warps);
- ``wb=N``, ``slabs=N``: N warps a slab over the branches, N slabs.

::

    python3 -m radiocapture_tpu_torch.tools.pfb_variants --source \\
        radiocapture_tpu_torch/tools/pfb_rows_ef6af1a.cu \\
        stores_only product_only no_epilogue cb=6
    python3 -m radiocapture_tpu_torch.tools.pfb_variants --m 6,20,25,100 \\
        direct f_stores_only f_product_only no_epilogue k=3

Every variant is built with the package's flags (all at once, one nvcc
process each) into ``_build/variants/``; for each its ptxas lines of the
``pfb_bins`` kernels, then per case the largest difference from
``pfb_bins_plain`` over max|bins|, whether the new history is
bit-identical to the plain version's, and its ms in ROUNDS rounds (the
order reversed every other round, ITERS launches each timed by CUDA
events). Prints the card's ``nvidia-smi`` name and power limit, then one
JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.device import require_cuda
from radiocapture_tpu_torch.ops import pfb_kernel as pk
from radiocapture_tpu_torch.ops.channelizer import PfbChannelizer
from radiocapture_tpu_torch.tools import track_turns
from radiocapture_tpu_torch.tools.track_turns import card_line, cuda_ms

ITERS = 10
ROUNDS = 4
BIN_RATE = 400e3
# M -> (sources, samples, wire) as chip_smoke.py's pfb bins cases
CASES = {6: (128, 240_000, "bfloat16"), 8: (16, 320_000, "complex64"),
         16: (16, 640_000, "float32"), 20: (16, 800_000, "bfloat16"),
         25: (16, 1_000_000, "bfloat16"), 50: (16, 2_000_000, "bfloat16"),
         100: (16, 4_000_000, "float32")}
# pfb_bins_launch of commit ef6af1a: hist, x, hp2, table, bins, new_hist,
# S, T, M, P, x_bf16, k, wb, slabs, stream
DIRECT_SIGNATURE = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8
                    + (ctypes.c_void_p,))

DIRECT_LOOP = "    for (int mp = 0; mp < M; ++mp) {\n"
DIRECT_STORE = ("      if (c < M) out[(long long)c * n + r] = "
                "make_float2(ar[k], ai[k]);\n")
FACTORED_SUM = "    for (int j = 0; j < N; j += 2) {\n"
FACTORED_STORE = "    dst[k * ds] = make_float2(re, im);\n"
NEVER = "__float_as_uint({}) == 0x7fc00001u"    # a NaN these data never give


def _never_store(store: str, value: str) -> str:
    """``store`` (one line ending in ``;``) done only when ``value`` is a
    NaN with one payload, which these data never give."""
    body = store.strip()
    indent = store[:len(store) - len(store.lstrip())]
    return f"{indent}if ({NEVER.format(value)}) {{ {body} }}\n"


EDITS = {
    "stores_only": [(DIRECT_LOOP, DIRECT_LOOP.replace("mp < M", "mp < 0"))],
    "product_only": [(DIRECT_STORE, DIRECT_STORE.replace(
        "if (c < M)", f"if (c < M && {NEVER.format('ar[k]')})"))],
    "f_stores_only": [(FACTORED_SUM, FACTORED_SUM.replace("j < N", "j < 0"))],
    "f_product_only": [(FACTORED_STORE, _never_store(FACTORED_STORE, "re"))],
}
EDITS["no_epilogue"] = [pair for key in EDITS for pair in EDITS[key]]
SIZED = {"cb": "constexpr int CB = {};",
         "f_unroll": "#pragma unroll {}\n  for (int k = 0; k < N; ++k) {{",
         "ksmall": "constexpr int K_SMALL = {};"}


def split(name: str) -> tuple[list, dict]:
    """A variant's source edits and plan overrides."""
    edits, plan = [], {}
    for part in name.split("+"):
        key, _, val = part.partition("=")
        if key in SIZED and val.isdigit():
            edits.append((key, int(val)))
        elif part in EDITS:
            edits.append((part, None))
        elif part == "direct":
            plan["factors"] = "direct"
        elif part == "kwire":
            plan["kwire"] = True
        elif key == "factors" and re.fullmatch(r"\d+x\d+", val):
            plan["factors"] = tuple(int(v) for v in val.split("x"))
        elif key in ("k", "wb", "slabs") and val.isdigit():
            plan[key] = int(val)
        else:
            raise SystemExit(f"unknown variant {part!r}\n{__doc__}")
    return edits, plan


def variant_source(src: str, edits: list) -> str:
    """``src`` with the edits applied; each edited text must occur once,
    except that ``no_epilogue`` edits whichever epilogues the source has."""
    for key, size in edits:
        if size is not None:
            text = SIZED[key]
            found = re.search(re.escape(text.format("@N@")).replace(
                "@N@", r"(\d+)"), src)
            if found is None:
                raise RuntimeError(f"{key}: the source has no {text!r}")
            src = src.replace(found.group(0), text.format(size))
            continue
        for old, new in EDITS[key]:
            if key == "no_epilogue" and old not in src:
                continue
            if src.count(old) != 1:
                raise RuntimeError(f"{key}: the source does not hold "
                                   f"{old!r} once")
            src = src.replace(old, new)
    return src


def factored_entry(src: str) -> bool:
    """Whether ``src``'s ``pfb_bins_launch`` takes M1 and M2."""
    params = re.search(r'extern "C" int pfb_bins_launch\(([^)]*)\)',
                       src).group(1)
    return len(params.split(",")) == len(kernels._SIGNATURES[
        "pfb_bins_launch"])


def build(source: Path, names: list) -> tuple[dict, dict]:
    """({name: its pfb_bins_launch}, {name: its ptxas lines of the
    pfb_bins kernels}) for the unchanged ``source`` ("base") and each
    variant's edits of it; a variant that only overrides the plan runs
    the base build."""
    src = source.read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    argtypes = (kernels._SIGNATURES["pfb_bins_launch"]
                if factored_entry(src) else DIRECT_SIGNATURE)
    procs = {}
    for name in ["base"] + [n for n in names if split(n)[0]]:
        stem = re.sub(r"[^0-9A-Za-z_]", "_", f"{source.stem}_{name}")
        cu = out_dir / f"{stem}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(src if name == "base"
                      else variant_source(src, split(name)[0]))
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        text = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        so.with_suffix(".ptxas.txt").write_text(text)
        lines = text.splitlines()
        ptxas[name] = [
            re.search(r"pfb_bins_kernel\w*?(Bf16Wire|F32Wire)\w*?Li(\d+)E",
                      l).group(0).split("kernel")[-1] + ": " + " | ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3])
            for i, l in enumerate(lines)
            if "Function properties" in l and "pfb_bins_kernel" in l]
        print(name, ptxas[name], flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "pfb_bins_launch")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    for name in names:          # plan overrides alone: the base build
        fns.setdefault(name, fns["base"])
    return fns, ptxas


def case_operands(m: int, dev):
    """(hist, x, hp2) of the case at M: the pfb mode's 80 dB bank at
    M · 400 kHz (the bench bank at M = 6), a random-normal history and
    block in the case's wire form."""
    s, t, wire = CASES[m]
    pfb = PfbChannelizer.for_rates(m * BIN_RATE, m, atten_db=80.0)
    gen = torch.Generator(device=dev).manual_seed(m)
    hist = torch.view_as_complex(torch.randn(
        (s, (pfb.p - 1) * m, 2), generator=gen, device=dev))
    x = torch.randn((s, t, 2), generator=gen, device=dev)
    x = (torch.view_as_complex(x) if wire == "complex64"
         else x.to(getattr(torch, wire)))
    return hist, x, pfb.device_hp2(dev)


def run_case(m: int, fns: dict, names: list, factored: bool, dev) -> dict:
    """Every build at case M: error against the plain version, history,
    ms in rounds."""
    hist, x, hp2 = case_operands(m, dev)
    want, want_hist = pk.pfb_bins_plain(hist, x, hp2)
    scale = float(want.abs().max())
    xr = torch.view_as_real(x) if x.is_complex() else x
    s, t = xr.shape[:2]
    p = hp2.shape[1]
    bf16 = xr.dtype == torch.bfloat16
    stream = torch.cuda.current_stream(dev).cuda_stream
    plans = {}
    for name in fns:
        over = split(name)[1] if name != "base" else {}
        fac = over.get("factors")
        fac = (1, m) if fac == "direct" or not factored else fac
        k, wb, slabs, m1, m2, shared = pk.bins_plan(m, p, bf16, fac)
        if over.get("kwire") or not factored:
            k, wb, slabs = track_turns.ef6af1a_plan(m, p, bf16)
        plans[name] = (over.get("k", k), over.get("wb", wb),
                       over.get("slabs", slabs), m1, m2, shared)

    def run(name):
        k, wb, slabs, m1, m2, _ = plans[name]
        table = pk.device_table(m, m1, m2, dev)
        bins = torch.empty((s, m, t // m), dtype=torch.complex64, device=dev)
        nh = torch.empty_like(hist)
        args = [hist.data_ptr(), xr.data_ptr(), hp2.data_ptr(),
                table.data_ptr(), bins.data_ptr(), nh.data_ptr(), s, t, m, p,
                int(bf16), k, wb, slabs] + ([m1, m2] if factored else [])
        kernels.check(fns[name](*args, stream), f"pfb_bins {name}")
        return bins, nh

    res = {}
    for name in list(fns):
        try:
            y, nh = run(name)
        except RuntimeError as err:     # a plan this case does not take
            print(f"M={m} {name} {plans[name]} refused: {err}", flush=True)
            res[name] = {"plan": plans[name], "refused": str(err)}
            fns = {k: v for k, v in fns.items() if k != name}
            continue
        res[name] = {
            "plan": dict(zip(("k", "wb", "slabs", "m1", "m2", "shared"),
                             plans[name])),
            "max_rel_err": float((y - want).abs().max()) / scale,
            "history_identical": torch.equal(
                torch.view_as_real(nh).view(torch.int32),
                torch.view_as_real(want_hist).view(torch.int32)),
            "ms": []}
        del y, nh
    keys = list(fns)          # the builds this case took
    for r in range(ROUNDS):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            res[key]["ms"].append(cuda_ms(lambda: run(key), ITERS))
    for key in keys:
        print(f"M={m} {key} {res[key]['plan']} ms",
              " ".join(f"{v:.4f}" for v in res[key]["ms"]),
              f"max rel err {res[key]['max_rel_err']:.3e} history "
              f"identical {res[key]['history_identical']}", flush=True)
    return {"S": s, "T": t, "wire": str(xr.dtype).split(".")[-1],
            "variants": res}


def main(argv: list[str]) -> None:
    source = kernels.CSRC / "pfb_rows.cu"
    ms = (6, 25, 100)
    while argv[:1] in (["--source"], ["--m"]) and len(argv) > 1:
        if argv[0] == "--source":
            source = Path(argv[1])
        else:
            ms = tuple(int(v) for v in argv[1].split(","))
        argv = argv[2:]
    if any(m not in CASES for m in ms):
        raise SystemExit(__doc__)
    factored = factored_entry(source.read_text())
    for name in argv:
        if split(name)[1] and not factored:
            raise SystemExit(f"{name}: {source} takes no plan's factors")
    dev = require_cuda()
    fns, ptxas = build(source, argv)
    res = {"source": str(source), "ptxas": ptxas,
           "cases": {m: run_case(m, fns, argv, factored, dev) for m in ms}}
    print(card_line())
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1:])
