"""Measurements of the bf16 flash kernels at head_dim 256 and 512 on one card.

    python3 chip_fwd_wide.py [--parent DIR [--steps] [--paths]
                             [--dtype float16]] [--variants a,b,...]

From the root of a checkout, on a machine with one CUDA card and ``nvcc``.
Two measurements, each optional (both run when neither flag is given):

- ``--parent DIR``: ``chip_smoke.py``'s phase-4 ``d256_timings`` and
  ``d512_timings`` (the three masks' kernels at 16 heads, 8192 tokens,
  bf16) on another checkout (the parent commit, unpacked with ``git
  archive``) and on this one, in turns: parent, this, this, parent, each
  in a process of its own (the two trees build their kernels apart).
  Prints each run's times of the forward (#1, #6, #9; beside SDPA's
  forward), dK/dV (#2, #7, #10) and dQ (#3, #8, #11), and of the three
  masks' kernels (with RMSNorm and SwiGLU) at the path shapes, head_dim 64
  (phase 4's ``timings``). With ``--dtype float16`` the turns time the
  kernels with fp16 io instead: the fixed-length ones at the path shape
  and at head_dim 256 and 512 (``fixed_timings``, beside SDPA's fp16
  forward), the varlen and flashmask ones at their path shapes. With
  ``--paths`` each turn also times phases 6 and 7's calls
  (``flash_attn_unpadded`` and ``flashmask_attention`` forward +
  backward, bf16, at their path shapes; the median of 7 samples of 10
  calls). With ``--steps`` each turn also runs ``chip_smoke.py``'s phases 5 and 10 (the compiled
  and the eager gpt2-medium step, head_dim 64, the eager one in bf16 and
  in fp16) and prints their median ms/step and device-busy ms beside the
  kernels'.
- ``--variants``: builds variants of ``paddle_tpu_torch/csrc``'s
  ``flash_fwd.cu``, ``flash_bwd_dq.cu`` or ``flash_bwd_dkv.cu`` (text
  changes of this checkout's sources, listed in ``VARIANTS``; ``lib_of``
  names the source), prints ptxas's registers and spills for the
  head_dim-256 instantiations, holds each variant that computes the same
  function against the plain versions (in a process of its own), and
  times the source's three bf16 kernels at D 256 and 512 at the phase-4
  shapes, variants in turns and then in reverse. The variants whose names
  start with ``x_`` leave a part of the work out (their results are
  wrong): they show what each part costs.

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

# the products from registers at head_dim 256 (O += P V, dQ += dS K,
# dV += P^T dO, dK += dS^T Q) as two m64n128k16 a 16-row step, over the B
# operand's two 128-column halves, in place of one m64n256k16
N128 = ("  if constexpr (D == 256) pt_hopper::wgmma_rs_n256<T>(acc, a, db);",
        "  if constexpr (D == 256) {\n"
        "    pt_hopper::wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(&acc[0]), a, db);\n"
        "    pt_hopper::wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(&acc[64]), a,\n"
        "                             db + (2 * HopTile<256>::BOX_BYTES >> 4));\n  }")
Q_LOADS = ("          tma_tile<256>(bufs + (2 * c + w) * Tile::BYTES, tm_q, q_full, "
           "q0 + w * BQ, h, packed,\n                        c * 256);\n    }\n  }\n")
# no TMA load: the ring's "full" barrier completes on thread 0's arrival
NO_EXPECT = ("      mbar_arrive_expect_tx(full + st.pos.slot, WideSmem::TILE);\n", "")


def _no_loads(call):
    return [NO_EXPECT, (call, "(void)map;\n    pt_hopper::mbar_arrive(bar);")]


# A variant's library is the first word of its name (after "x_"): "dq" and
# "dkv" build flash_bwd_dq.cu and flash_bwd_dkv.cu and time the three masks'
# dQ or dK/dV kernels; every other name builds flash_fwd.cu and times the
# forwards.
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
    "x_no_pv": [("      for (int k = 0; k < 4; ++k)\n        wgmma_rs_d<256, T>(acc, pa[k], "
                 "Tile::mn_major(slot_addr(vs), k));",
                 "      for (int k = 0; k < 4; ++k) fence_regs(pa[k]);")],
    "x_no_s": [("        wgmma_nt<256, T>(sc, q_addr, slot_addr(ks), c > 0);\n", "")],
    "x_no_loads": [("      mbar_arrive_expect_tx(full + ip.slot, Tile::BYTES);\n"
                    "      tma_tile<256>(ring + ip.slot * Tile::BYTES, map, full + ip.slot, "
                    "row, h, packed,\n                    (is_v ? cz : c) * 256);",
                    "      (void)map;\n      (void)row;\n      (void)c;\n"
                    "      mbar_arrive(full + ip.slot);")],
    "x_no_stores": [("      *reinterpret_cast<uint32_t*>(orow + 8 * jd) =\n",
                     "      if (acc[4 * jd + 2 * h2] == 1.2345f) "
                     "*reinterpret_cast<uint32_t*>(orow + 8 * jd) =\n")],
    # the backward's: as built, the products from registers as 2 x n128,
    # and breakdowns: no lo products (dS or P rounded once to bf16), no dS
    # arithmetic (dQ: no P either; dK/dV: both warpgroups compute P alone),
    # no S and dP products, no TMA loads
    "dq_base": [],
    "dq_n128": [N128],
    "x_dq_no_lo": [("        wgmma_rs_d<256, T>(acc, al[k], Tile::mn_major(ring.addr(ks), k));\n",
                    "")],
    "x_dq_no_ds": [("      if (mask.tile_full(qt, j))\n        dq_ds_tile<true>",
                    "      if (lse2[0] == 1.2345f)\n        dq_ds_tile<true>"),
                   ("      else\n        dq_ds_tile<false>(mask, j, qi, cq, scale, lse2, dl, "
                    "sc, dp);", "")],
    "x_dq_no_s": [("        wgmma_nt<256, T>(sc, q_addr, ring.addr(ks), ci > 0);  "
                   "// S += Q_c K_c^T\n        wgmma_nt<256, T>(dp, do_addr, ring.addr(vs), "
                   "ci > 0);  // dP += dO_c V_c^T\n", "")],
    "x_dq_no_loads": _no_loads("tma_tile<256>(dst, map, bar, kv ? is.tile * BK : q0 + "
                               "(sub & 1) * BQ, h, packed, c * 256);"),
    "dkv_base": [],
    "dkv_n128": [N128],
    "x_dkv_no_lo": [("      wgmma_rs_d<256, T>(acc, al[k], Tile::mn_major(b_addr, k));\n",
                     "")],
    "x_dkv_no_ds": [("    const bool whole = mask.tile_full(i, kt);\n    if (w) {",
                      "    const bool whole = mask.tile_full(i, kt);\n    if (stat == 1.2345f) {")],
    "x_dkv_no_s": [("        wgmma_nt<256, T>(st, k_addr, ring.addr(qs), ci > 0);   // S^T += "
                    "K_c Q_c^T\n        wgmma_nt<256, T>(dpt, v_addr, ring.addr(ds), ci > 0);  "
                    "// dP^T += V_c dO_c^T\n", ""),
                   ("        wgmma_nt<256, T>(st, k_addr, ring.addr(qs), ci > 0);  // S^T += "
                    "K_c Q_c^T\n", "")],
    "x_dkv_no_loads": _no_loads("tma_tile<256>(dst, map, bar, qo ? is.tile * BQ : k0, h, "
                                "packed, c * 256);"),
}
# per library: its source and the kernels (wrapper names) a variant times
LIBS = {"fwd": ("flash_fwd.cu", ("flash_fwd", "varlen_fwd", "flashmask_fwd")),
        "dq": ("flash_bwd_dq.cu", ("flash_bwd_dq", "varlen_bwd_dq",
                                   "flashmask_bwd_dq")),
        "dkv": ("flash_bwd_dkv.cu", ("flash_bwd_dkv", "varlen_bwd_dkv",
                                     "flashmask_bwd_dkv"))}


def lib_of(name):
    word = (name[2:] if name.startswith("x_") else name).split("_")[0]
    return word if word in LIBS else "fwd"


def _cs():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def build(names):
    """Builds each variant's source into WORK/<name>/lib.so, nvcc processes
    in parallel; prints ptxas's head_dim-256 lines."""
    from paddle_tpu_torch.ops.cuda import _build
    procs = {}
    for name in names:
        source = LIBS[lib_of(name)][0]
        d = os.path.join(WORK, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d, ignore=shutil.ignore_patterns("build"))
        for a, b in VARIANTS[name]:
            for f in (source, "flash_common.cuh"):
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
             os.path.join(d, source)], stdout=subprocess.PIPE,
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
            elif entry and "_hopperILi256" in entry:
                tag = re.search(r"ILi256E(\d+\w+?)?NS_\d+(\w+?Mask)ELb(\d)",
                                entry)
                io = "fp16" if tag.group(1) == "6__half" else "bf16"
                print(f"  {name} {io} {tag.group(2)} SPLIT {tag.group(3)}: "
                      f"{ln}")
            elif "wgmma" in ln:
                print(f"  {name}: {ln}")
        libs[name] = lib
    return libs


def use(lib_path, lib_name):
    """Points the wrappers of one library's three kernels at a variant's
    build of it."""
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    lib = ctypes.CDLL(lib_path)
    fixed, varlen, flashmask = LIBS[lib_name][1]
    for sym, argtypes in (fa._SIGNATURES[fixed], fv._SIGNATURES[varlen][1:],
                          fv._SIGNATURES[flashmask][1:]):
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _build._FUNCS[sym] = fn


def check_variant(name):
    """The variant's bf16 kernels against the plain versions (chip_smoke's
    limits), at head_dim 256, 512 and 768, the three masks."""
    cs = _cs()
    use(os.path.join(WORK, name, "lib.so"), lib_of(name))
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


def kernels(lib_name):
    """One library's three bf16 kernels at the phase-4 shapes, D 256 and
    512 (the backward from the forward's lse and out)."""
    cs = _cs()
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    out = {}
    for d in (256, 512):
        scale = 1 / math.sqrt(d)
        q, k, v, do = cs._inputs(cs.BATCH * cs.D256_HEADS, cs.SEQ, cs.SEQ, d,
                                 torch.bfloat16, seed=60)
        args = (True, scale, cs.SEQ, 0)
        o, lse = fa.flash_fwd(q, k, v, *args)
        fixed = (q, k, v, do, lse, fa.attention_delta(do, o))
        vq, vk, vv, vdo, _, _, plan = cs._varlen_inputs(
            cs.DOCS, cs.DOCS, 0, 0, cs.D256_HEADS, d, torch.bfloat16, True,
            seed=61)
        o, vlse = fv.varlen_fwd(vq, vk, vv, plan, scale)
        varlen = (vq, vk, vv, vdo, vlse, fv.varlen_delta(vdo, o))
        q4, k4, v4, do4 = cs._flashmask_inputs(
            2, cs.FM_SEQ, cs.FM_SEQ, cs.D256_HEADS, d, torch.bfloat16,
            seed=62)
        fq, fk, fvv, fdo = (cs._heads(x) for x in (q4, k4, v4, do4))
        fplan = fv.flashmask_plan(
            torch.from_numpy(cs.flashmask_startend()).cuda(), cs.D256_HEADS,
            True)
        o, flse = fv.flashmask_fwd(fq, fk, fvv, fplan, scale)
        fm = (fq, fk, fvv, fdo, flse, fa.attention_delta(fdo, o))
        n_in = 3 if lib_name == "fwd" else 6
        calls = {"fixed": (getattr(fa, LIBS[lib_name][1][0]), fixed, args),
                 "varlen": (getattr(fv, LIBS[lib_name][1][1]), varlen,
                            (plan, scale)),
                 "flashmask": (getattr(fv, LIBS[lib_name][1][2]), fm,
                               (fplan, scale))}
        for mask, (fn, ins, extra) in calls.items():
            out[f"{mask} {d}"] = lambda f=fn, t=ins[:n_in], x=extra: f(*t, *x)
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
    for lib_name in LIBS:
        group = [n for n in libs if lib_of(n) == lib_name]
        if not group:
            continue
        fns = kernels(lib_name)
        times = {}
        with cs.watchdog("variant timings", 600):
            for name in group + group[::-1]:
                use(libs[name], lib_name)
                for key, fn in fns.items():
                    times.setdefault((name, key), []).append(
                        cs.cuda_ms(fn, 20))
        for key in fns:
            print(f"{lib_name} {key}: " + ", ".join(
                f"{n} {' / '.join(f'{t:.4f}' for t in times[(n, key)])}"
                for n in group) + " ms", flush=True)
        del fns
        torch.cuda.empty_cache()


# one turn of the parent comparison, run with ``python -c`` in a checkout
# (its own chip_smoke.py and package, first on sys.path); argv[1] "1" adds
# the gpt2-medium steps, whose median ms and device-busy ms it reads from
# the arguments of chip_smoke's ``profile_step`` and the profiler's line
TURN = """
import json, sys, chip_smoke as cs
_, _, smi = cs.card()
cs.build()
rows = {}
with cs.watchdog("timings", 600):
    if sys.argv[2] == "float16":
        f16 = cs.torch.float16
        runs = [(hd, lambda hd=hd: cs.fixed_timings(
            cs.BATCH, cs.HEADS if hd == 64 else cs.D256_HEADS, cs.SEQ, hd,
            seed=66, dtype=f16)) for hd in (64, 256, 512)]
        runs += [(64, lambda: cs.varlen_timings(cs.HEADS, 64, seed=68,
                                                dtype=f16)),
                 (64, lambda: cs.flashmask_timings(cs.HEADS, 64, seed=69,
                                                   dtype=f16))]
    else:
        runs = ((64, cs.timings), (256, cs.d256_timings),
                (512, cs.d512_timings))
    for hd, fn in runs:
        ms, _, lib, bnd = fn()
        for k in ms:
            rows[f"{k} {hd}"] = (ms[k], lib[k], bnd[k][0])
if sys.argv[3] == "1":
    import math, statistics
    import paddle_tpu_torch.nn.functional as F
    vq, vk, vv, vdo, cu, _, _ = cs._varlen_inputs(
        cs.DOCS, cs.DOCS, 0, 0, cs.HEADS, cs.HEAD_DIM, cs.torch.bfloat16, True, seed=3)
    fq, fk, fv, fdo = cs._flashmask_inputs(
        2, cs.FM_SEQ, cs.FM_SEQ, cs.HEADS, cs.HEAD_DIM, cs.torch.bfloat16, seed=6)
    startend = cs.torch.from_numpy(cs.flashmask_startend()).cuda()
    for t in (vq, vk, vv, fq, fk, fv):
        t.requires_grad_()
    def varlen():
        F.flash_attn_unpadded(vq, vk, vv, cu, cu, max(cs.DOCS), max(cs.DOCS),
                              1.0 / math.sqrt(cs.HEAD_DIM), causal=True)[0].backward(vdo)
    def flashmask():
        F.flashmask_attention(fq, fk, fv, startend, causal=True).backward(fdo)
    for name, fn in (("varlen path", varlen), ("flashmask path", flashmask)):
        ms = [cs.cuda_ms(fn, 10) for _ in range(7)]
        print(name, "samples", " ".join(f"{m:.4f}" for m in ms))
        rows[f"{name} fwd+bwd"] = (statistics.median(ms), None, None)
if sys.argv[1] == "1":
    medians = []
    profile = cs.profile_step
    def profiled(step, state, tokens, labels, step_ms, group=None):
        medians.append(step_ms)
        return profile(step, state, tokens, labels, step_ms, group)
    cs.profile_step = profiled
    torch = cs.torch
    torch.cuda.empty_cache()
    _, compiled = cs.main_path()
    torch.cuda.empty_cache()
    cs.eager_path(smi, compiled)
    rows["compiled gpt2-medium step"] = (medians[0], None, None)
    rows["eager gpt2-medium step"] = (medians[1], None, None)
    rows["eager fp16 gpt2-medium step"] = (medians[2], None, None)
print("TIMINGS " + json.dumps(rows))
"""


def parent(other, steps, dtype, paths):
    results = []
    for tree in (other, ROOT, ROOT, other):
        t0 = time.time()
        rc = subprocess.run([sys.executable, "-c", TURN, str(int(steps)),
                             dtype, str(int(paths))], cwd=tree,
                            capture_output=True, text=True)
        line = [ln for ln in rc.stdout.splitlines()
                if ln.startswith("TIMINGS ")]
        if rc.returncode or not line:
            raise SystemExit(f"{tree}: rc {rc.returncode}\n"
                             f"{(rc.stdout + rc.stderr)[-3000:]}")
        label = "parent" if tree == other else "this"
        results.append((label, json.loads(line[0][len("TIMINGS "):])))
        print(f"{label} ({tree}) in {time.time() - t0:.1f} s", flush=True)
        for ln in rc.stdout.splitlines():
            if ("device busy" in ln or "median" in ln and "ms/step" in ln
                    or "path samples" in ln):
                print(f"  {label}: {ln}", flush=True)
    for key in results[0][1]:
        lib = [r[key][1] for _, r in results]
        sdpa = "" if None in lib else \
            f"; sdpa {' / '.join(f'{t:.4f}' for t in lib)} ms"
        bound = results[0][1][key][2]
        print(f"{key}: " + ", ".join(
            f"{label} {r[key][0]:.4f}" for label, r in results) +
            f" ms{sdpa}" + ("" if bound is None else
                            f"; bound {bound:.4f} ms"), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16"))
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
        parent(os.path.abspath(a.parent), a.steps, a.dtype, a.paths)
    if a.variants or not a.parent:
        variants((a.variants or ",".join(VARIANTS)).split(","))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
