"""Measurements of the bf16 flash forward at head_dim 256 and 512 on one card.

    python3 chip_fwd_wide.py [--parent DIR] [--variants a,b,...]

From the root of a checkout, on a machine with one CUDA card and ``nvcc``.
Two measurements, each optional (both run when neither flag is given):

- ``--parent DIR``: ``chip_smoke.py``'s phase-4 ``d256_timings`` and
  ``d512_timings`` (the three masks' kernels at 16 heads, 8192 tokens,
  bf16) on another checkout (the parent commit, unpacked with ``git
  archive``) and on this one, in turns: parent, this, this, parent, each
  in a process of its own (the two trees build their kernels apart).
  Prints each run's forward times beside SDPA's.
- ``--variants``: builds variants of ``paddle_tpu_torch/csrc/flash_fwd.cu``
  (text changes of this checkout's source, listed in ``VARIANTS``),
  prints ptxas's registers and spills for the head_dim-256
  instantiations, holds each variant that computes the same function
  against the plain versions (in a process of its own), and times the
  three bf16 forwards at D 256 and 512 at the phase-4 shapes, variants in
  turns and then in reverse. The variants whose names start with ``x_``
  leave a part of the work out (their results are wrong): they show what
  each part costs.

Exits non-zero with no CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "paddle_tpu_torch", "csrc", "build", "variants")

# O += P V at head_dim 256 as two m64n128k16 a 16-key step, over V's two
# 128-column halves, in place of one m64n256k16
N128 = ("  if constexpr (D == 256) pt_hopper::wgmma_rs_n256(acc, a, db);",
        "  if constexpr (D == 256) {\n"
        "    pt_hopper::wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&acc[0]), a, db);\n"
        "    pt_hopper::wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&acc[64]), a,\n"
        "                             db + (2 * HopTile<256>::BOX_BYTES >> 4));\n  }")
Q_LOADS = ("          tma_tile<256>(bufs + (2 * c + w) * Tile::BYTES, tm_q, q_full, "
           "q0 + w * BQ, h, packed,\n                        c * 256);\n    }\n  }\n")
VARIANTS = {
    "base": [],
    "n128": [N128],
    # one "empty" arrival per warp (lane 0, after __syncwarp) in place of
    # one per thread
    "warp_arrive": [("mbar_init(empty + s, WIDE_NT);",
                     "mbar_init(empty + s, WIDE_NT / 32);")] + [
        (f"mbar_arrive(empty + {x});",
         f"__syncwarp();\n        if ((threadIdx.x & 31) == 0) mbar_arrive(empty + {x});")
        for x in ("qs0", "qs1", "ks", "vs")],
    # the first K/V loads issued beside Q's rather than after Q arrived
    "early_kv": [(Q_LOADS, Q_LOADS.replace("    }\n  }\n", "    }\n    issue(0);\n  }\n"))],
    # breakdowns: no softmax (P = S), no P V, no S = Q K^T, no TMA loads
    # (the barriers still complete), no output stores
    "x_no_softmax": [("      softmax_tile(mask, qt, j, qi, cq, scale, sc, m, l, alpha);\n"
                      "#pragma unroll\n      for (int jd = 0; jd < 32; ++jd)",
                      "      alpha[0] = alpha[1] = 1.f;\n"
                      "#pragma unroll\n      for (int jd = 0; jd < 32; ++jd)")],
    "x_no_pv": [("      for (int k = 0; k < 4; ++k) wgmma_rs_d<256>(acc, pa[k], "
                 "Tile::mn_major(slot_addr(vs), k));",
                 "      for (int k = 0; k < 4; ++k) fence_regs(pa[k]);")],
    "x_no_s": [("        wgmma_nt<256>(sc, q_addr, slot_addr(ks), c > 0);\n", "")],
    "x_no_loads": [("      mbar_arrive_expect_tx(full + ip.slot, Tile::BYTES);\n"
                    "      tma_tile<256>(ring + ip.slot * Tile::BYTES, map, full + ip.slot, "
                    "row, h, packed,\n                    (is_v ? cz : c) * 256);",
                    "      (void)map;\n      (void)row;\n      (void)c;\n"
                    "      mbar_arrive(full + ip.slot);")],
    "x_no_stores": [("      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd) = "
                     "__floats2bfloat162_rn(",
                     "      if (acc[4 * jd + 2 * h2] == 1.2345f) "
                     "*reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd) = "
                     "__floats2bfloat162_rn(")],
}


def _cs():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def build(names):
    """Builds each variant's flash_fwd.cu into WORK/<name>/lib.so, nvcc
    processes in parallel; prints ptxas's head_dim-256 lines."""
    from paddle_tpu_torch.ops.cuda import _build
    procs = {}
    for name in names:
        d = os.path.join(WORK, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d, ignore=shutil.ignore_patterns("build"))
        for a, b in VARIANTS[name]:
            for f in ("flash_fwd.cu", "flash_common.cuh"):
                path = os.path.join(d, f)
                text = open(path).read()
                if a in text:
                    open(path, "w").write(text.replace(a, b))
                    break
            else:
                raise SystemExit(f"{name}: text not found: {a[:60]!r}")
        lib = os.path.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, "flash_fwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}{err}"[-4000:])
        entry = None
        for ln in _build._ptxas_lines(err):
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1)
            elif entry and "flash_fwd_hopperILi256" in entry:
                tag = re.search(r"ILi256ENS_\d+(\w+?Mask)ELb(\d)", entry)
                print(f"  {name} {tag.group(1)} SPLIT {tag.group(2)}: {ln}")
            elif "wgmma" in ln:
                print(f"  {name}: {ln}")
        libs[name] = lib
    return libs


def use(lib_path):
    """Points the three forward wrappers at a variant's library."""
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    lib = ctypes.CDLL(lib_path)
    for sym, argtypes in (
            ("pt_flash_fwd", fa._SIGNATURES["flash_fwd"][1]),
            ("pt_varlen_fwd", fv._SIGNATURES["varlen_fwd"][2]),
            ("pt_flashmask_fwd", fv._SIGNATURES["flashmask_fwd"][2])):
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _build._FUNCS[sym] = fn


def check_variant(name):
    """The variant's bf16 forwards against the plain versions (chip_smoke's
    limits), at head_dim 256, 512 and 768, the three masks."""
    cs = _cs()
    use(os.path.join(WORK, name, "lib.so"))
    cs.card()
    with cs.watchdog("variant check", 300):
        for d in (256, 512, 768):
            cs.hold_against_plain(4, 200, 136, d, torch.bfloat16, True, 50)
            cs.hold_against_plain(2, 1000, 1000, d, torch.bfloat16, True, 51)
            cs.hold_varlen_against_plain(*cs.EDGE, 2, d, torch.bfloat16, True,
                                         seed=51)
            cs.hold_flashmask_against_plain(
                2, 200, 136, 2, d, torch.bfloat16, True,
                cs._fm_edge_startend(2, 2, 200, 136, seed=7), seed=52)
        torch.cuda.synchronize()


def forwards():
    """The three bf16 forwards at the phase-4 shapes, D 256 and 512."""
    cs = _cs()
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    out = {}
    for d in (256, 512):
        scale = 1 / math.sqrt(d)
        q, k, v, _ = cs._inputs(cs.BATCH * cs.D256_HEADS, cs.SEQ, cs.SEQ, d,
                                torch.bfloat16, seed=60)
        args = (True, scale, cs.SEQ, 0)
        out[f"fixed {d}"] = lambda q=q, k=k, v=v, a=args: fa.flash_fwd(
            q, k, v, *a)
        vq, vk, vv, _, _, _, plan = cs._varlen_inputs(
            cs.DOCS, cs.DOCS, 0, 0, cs.D256_HEADS, d, torch.bfloat16, True,
            seed=61)
        out[f"varlen {d}"] = lambda q=vq, k=vk, v=vv, p=plan, s=scale: \
            fv.varlen_fwd(q, k, v, p, s)
        q4, k4, v4, _ = cs._flashmask_inputs(2, cs.FM_SEQ, cs.FM_SEQ,
                                             cs.D256_HEADS, d, torch.bfloat16,
                                             seed=62)
        fq, fk, fvv = (cs._heads(x) for x in (q4, k4, v4))
        fplan = fv.flashmask_plan(
            torch.from_numpy(cs.flashmask_startend()).cuda(), cs.D256_HEADS,
            True)
        out[f"flashmask {d}"] = lambda q=fq, k=fk, v=fvv, p=fplan, s=scale: \
            fv.flashmask_fwd(q, k, v, p, s)
    return out


def variants(names):
    cs = _cs()
    libs = build(names)
    for name in names:
        if name.startswith("x_"):
            continue
        rc = subprocess.run([sys.executable, __file__, "--check", name],
                            capture_output=True, text=True)
        bad = [ln for ln in (rc.stdout + rc.stderr).splitlines()
               if "check failed" in ln or "Error" in ln]
        print(f"variant {name}: against the plain versions rc "
              f"{rc.returncode} {' | '.join(bad)[:400]}", flush=True)
        if rc.returncode:
            del libs[name]
    fns = forwards()
    times = {}
    with cs.watchdog("variant timings", 600):
        for name in list(libs) + list(libs)[::-1]:
            use(libs[name])
            for key, fn in fns.items():
                times.setdefault((name, key), []).append(cs.cuda_ms(fn, 20))
    for key in fns:
        print(f"{key}: " + ", ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in times[(n, key)])}"
            for n in libs) + " ms", flush=True)


# one turn of the parent comparison, run with ``python -c`` in a checkout
# (its own chip_smoke.py and package, first on sys.path)
TURN = """
import json, chip_smoke as cs
cs.card()
cs.build()
rows = {}
with cs.watchdog("timings", 600):
    for hd, fn in ((256, cs.d256_timings), (512, cs.d512_timings)):
        ms, _, lib, bnd = fn()
        for k in ("flash_fwd", "varlen_fwd", "flashmask_fwd"):
            rows[f"{k} {hd}"] = (ms[k], lib[k], bnd[k][0])
print("TIMINGS " + json.dumps(rows))
"""


def parent(other):
    results = []
    for tree in (other, ROOT, ROOT, other):
        t0 = time.time()
        rc = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                            capture_output=True, text=True)
        line = [ln for ln in rc.stdout.splitlines()
                if ln.startswith("TIMINGS ")]
        if rc.returncode or not line:
            raise SystemExit(f"{tree}: rc {rc.returncode}\n"
                             f"{(rc.stdout + rc.stderr)[-3000:]}")
        label = "parent" if tree == other else "this"
        results.append((label, json.loads(line[0][len("TIMINGS "):])))
        print(f"{label} ({tree}) in {time.time() - t0:.1f} s", flush=True)
    for key in results[0][1]:
        print(f"{key}: " + ", ".join(
            f"{label} {r[key][0]:.4f}" for label, r in results) +
            f" ms; sdpa {' / '.join(f'{r[key][1]:.4f}' for _, r in results)}"
            f" ms; bound {results[0][1][key][2]:.4f} ms", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--variants")
    ap.add_argument("--check")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_fwd_wide: no CUDA device", file=sys.stderr)
        return 1
    if a.check:
        check_variant(a.check)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    if a.parent:
        parent(os.path.abspath(a.parent))
    if a.variants or not a.parent:
        variants((a.variants or ",".join(VARIANTS)).split(","))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
