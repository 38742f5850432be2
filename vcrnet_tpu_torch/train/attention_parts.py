"""What the attention and soft-correspondence kernels' time is made of on the card.

    python3 -m vcrnet_tpu_torch.train.attention_parts [--csrc DIR] [--sizes 1024,1000,885]

Compiles ``flash_packed.cu``, ``colmass.cu``, ``pointer_mha.cu``,
``flash_bwd.cu`` and ``vcp_bwd.cu`` from ``--csrc`` (default: this
package's sources; another checkout's ``vcrnet_tpu_torch/csrc`` times that
checkout's kernels: the C interfaces of all but ``pointer_mha.cu`` are the
same, and ``pointer_mha.cu`` is called with or without its Q scratch as its
source declares it), each alone with nvcc into a shared library with a C
shim, and times them with CUDA events (median of 25) on seeded random bf16
inputs:

* ``flash_packed``, whose loop the other two share, at B = 64, N = 1024
  (without and with the row logsumexp) and at B = 8, Nq = 3072 over 2368
  keys of which 2353 are valid (the partial-3072 request's attention over
  its kept keys);

* ``softmax_colmass`` at B = 8 and 2, Nq = Nk = 3072, 4 heads of 128 (the
  partial-3072 request's re-mask), and a build without its second kernel
  (the launch of the column masses cut from the source text): the row
  logsumexps alone; the difference is the mass pass;
* ``fused_mha`` at B = 64 and 8, N = 1024, D = 512, 4 heads, as
  cross-attention and self-attention, beside the library call that
  computes the same sublayer (``F.multi_head_attention_forward``), and
  builds with launches cut: for a source of three kernels (projections,
  attention, out projection) the projections alone and the projections
  with the attention, so that each kernel's time is a difference; for a
  source of two (K/V projection, then Q projection, attention and out
  projection in one) the K/V projection alone. A cut whose text the source
  does not hold is reported and skipped; the cut builds' results are
  wrong and only their times are read; and builds of ``pointer_mha.cu``
  from a copy of the sources with one change (``VARIANTS``: the products'
  epilogue without its stores, a ring of two stages), beside the
  library's own products (one for q, k and v, one for the out projection);
* the training step's backward kernels at each cloud size N of ``--sizes``
  (default 1024): ``flash_bwd`` at B = 64, Nq = Nk = N, from the plain
  forward's output and logsumexp (the lse in whole 64-value tiles a
  (b, h), +inf past N, as ``ops/attention.py::flash_bwd`` hands it over),
  and ``vcp_bwd`` at B = 64, Ns = Nt = N, E = 512, from the plain
  forward's correspondences and logsumexp (its scratch and lse in whole
  64-row tiles an item, as ``ops/vcp.py::vcp_bwd`` does). Sources from
  before the backward kernels took ragged tiles refuse N % 64 != 0, or read
  the padded lse misaligned: give them ``--sizes 1024`` alone.

The full builds are held against the plain versions first (2e-2 absolute
for the attention, 1e-3 of the largest mass, 2^-6 of the largest output of
the sublayer, 1e-2 relative for the backward gradients), and the library
call against
the plain version too (5e-2: it rounds elsewhere), so that a wrong call
through a shim cannot pass for a time. Prints the card's ``nvidia-smi``
name and power limit first, one line a timing, and last one JSON object of
them all. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess

import torch
import torch.nn.functional as F

from vcrnet_tpu_torch.ops import _build, attention, colmass, pointer, vcp
from vcrnet_tpu_torch.train.edge_conv_parts import _call, build, rel_err, time_ms
from vcrnet_tpu_torch.train.gather_max_parts import _variant_sources

H, DK = 4, 128
D = H * DK
E = 512  # the soft correspondence's embedding width
BUILD_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "attention_parts")

_FLASH_SHIM = """
extern "C" int shim(const void* q, const void* k, const void* v, void* out, float* lse,
                    int batch, int nq, int nk, int nk_valid, int n_heads, float sm_scale,
                    void* stream) {
  return static_cast<int>(vcr_flash_packed(q, k, v, out, lse, batch, nq, nk, nk_valid, n_heads,
                                           sm_scale, static_cast<cudaStream_t>(stream)));
}
"""
_COLMASS_SHIM = """
extern "C" int shim(const void* q, const void* k, float* lse, float* out, int batch, int nq,
                    int nk, int n_heads, float sm_scale, void* stream) {
  return static_cast<int>(vcr_softmax_colmass(q, k, lse, out, batch, nq, nk, n_heads, sm_scale,
                                              static_cast<cudaStream_t>(stream)));
}
"""
_FLASH_BWD_SHIM = """
extern "C" int shim(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, float* delta, void* dq, void* dk, void* dv, int batch,
                    int nq, int nk, int n_heads, float sm_scale, void* stream) {
  return static_cast<int>(vcr_flash_bwd(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, nq, nk,
                                        n_heads, sm_scale, static_cast<cudaStream_t>(stream)));
}
"""
_VCP_BWD_SHIM = """
extern "C" int shim(const void* src_emb, const void* tgt_emb, const float* tgt, const float* corr,
                    const float* dcorr, const float* lse, float* keys, float* rows, float* d_src,
                    float* d_tgt_emb, float* d_tgt, int batch, int ns, int nt, int e,
                    void* stream) {
  return static_cast<int>(vcr_vcp_bwd(src_emb, tgt_emb, tgt, corr, dcorr, lse, keys, rows, d_src,
                                      d_tgt_emb, d_tgt, batch, ns, nt, e,
                                      static_cast<cudaStream_t>(stream)));
}
"""
# pointer_mha.cu with a Q scratch (projections, attention and out projection
# as three kernels), and without (the earlier design's two kernels); the shim's own
# argument list is the same
_MHA_SHIM_Q = """
extern "C" int shim(const void* yq, const void* ykv, const void* wq, const void* bq,
                    const void* wk, const void* bk, const void* wv, const void* bv,
                    const void* wo, const void* bo, void* qscr, void* kscr, void* vscr, void* out,
                    int batch, int nq, int nk, int d, int n_heads, void* stream) {
  return static_cast<int>(vcr_pointer_mha(yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo, qscr, kscr,
                                          vscr, out, batch, nq, nk, d, n_heads,
                                          static_cast<cudaStream_t>(stream)));
}
"""
_MHA_SHIM_KV = """
extern "C" int shim(const void* yq, const void* ykv, const void* wq, const void* bq,
                    const void* wk, const void* bk, const void* wv, const void* bv,
                    const void* wo, const void* bo, void* qscr, void* kscr, void* vscr, void* out,
                    int batch, int nq, int nk, int d, int n_heads, void* stream) {
  (void)qscr;
  return static_cast<int>(vcr_pointer_mha(yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo, kscr, vscr,
                                          out, batch, nq, nk, d, n_heads,
                                          static_cast<cudaStream_t>(stream)));
}
"""

# cuts: (text in the source, its replacement); the first whose text the
# source holds is made
_COLMASS_LSE_ONLY = (
    ("  if (err != cudaSuccess) return err;\n  colmass_kernel<<<",
     "  return err;\n  colmass_kernel<<<"),
    ("  err = cudaGetLastError();\n  if (err != cudaSuccess) return err;\n  colmass_kernel<<<",
     "  return cudaGetLastError();\n  colmass_kernel<<<"),
)
_MHA_PROJECTIONS_ONLY = (
    ("  if (err == cudaSuccess) err = launch_gemm(qkv, stream);\n"
     "  if (err != cudaSuccess) return err;\n",
     "  if (err == cudaSuccess) err = launch_gemm(qkv, stream);\n  return err;\n"),
    ("  err = cudaGetLastError();\n  if (err != cudaSuccess) return err;\n\n"
     "  const size_t smem = vcr_pointer_mha_smem(d);",
     "  return cudaGetLastError();\n\n  const size_t smem = vcr_pointer_mha_smem(d);"),
)
_MHA_NO_OUT_PROJECTION = (
    ("  if (err != cudaSuccess) return err;\n  return launch_gemm(proj, stream);",
     "  return err;\n  return launch_gemm(proj, stream);"),
)
# builds of pointer_mha.cu from a copy of the sources with one change:
# {variant: [(file, text, replacement)]}
_GEMM = "gemm_wgmma.cuh"
VARIANTS = {
    # the products' epilogue fills its shared-memory boxes but issues no
    # store (a condition the compiler cannot decide): what the stores cost
    "gemm_no_tma_stores": [(_GEMM, "        tma_store_box(&job.out,",
                            "        if (job.rows < 0) tma_store_box(&job.out,")],
    "gemm_stages_2": [(_GEMM, "constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}


def _pick(text: str, alternatives) -> tuple:
    """The cut of ``alternatives`` whose text ``text`` holds, as a tuple of
    cuts for ``build``, or None."""
    for old, new in alternatives:
        if old in text:
            return ((old, new),)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=_build.CSRC_DIR, help="the kernels' source directory")
    ap.add_argument("--sizes", default="1024",
                    help="cloud sizes N of the backward kernels, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {smi.strip().splitlines()[0]}; sources {os.path.abspath(args.csrc)}",
          flush=True)
    texts = {}
    for src in ("colmass.cu", "pointer_mha.cu"):
        with open(os.path.join(args.csrc, src)) as fh:
            texts[src] = fh.read()
    three = "void* qscr" in texts["pointer_mha.cu"]
    shims = {"flash_packed.cu": _FLASH_SHIM, "colmass.cu": _COLMASS_SHIM,
             "pointer_mha.cu": _MHA_SHIM_Q if three else _MHA_SHIM_KV,
             "flash_bwd.cu": _FLASH_BWD_SHIM, "vcp_bwd.cu": _VCP_BWD_SHIM}
    cuts = {"colmass_lse_only": ("colmass.cu", _COLMASS_LSE_ONLY),
            "fused_mha_projections_only": ("pointer_mha.cu", _MHA_PROJECTIONS_ONLY),
            "fused_mha_no_out_projection": ("pointer_mha.cu", _MHA_NO_OUT_PROJECTION)}
    jobs = {"flash_packed": ("flash_packed.cu", ()), "colmass": ("colmass.cu", ()),
            "fused_mha": ("pointer_mha.cu", ()), "flash_bwd": ("flash_bwd.cu", ()),
            "vcp_bwd": ("vcp_bwd.cu", ())}
    for name, (src, alternatives) in cuts.items():
        picked = _pick(texts[src], alternatives)
        if picked is None:
            print(f"{name}: the source holds no such launch; skipped", flush=True)
        else:
            jobs[name] = (src, picked)
    # one build directory per source tree, so that two trees timed in one
    # run do not share libraries
    tag = hashlib.sha1(os.path.abspath(args.csrc).encode()).hexdigest()[:12]
    libs = build(args.csrc, jobs, shims, os.path.join(BUILD_DIR, tag))
    variants = {}
    for name, patches in VARIANTS.items():
        vdir = os.path.join(BUILD_DIR, tag, name)
        vsrc = _variant_sources(args.csrc, vdir, patches) if three else None
        if vsrc is None:
            print(f"{name}: the sources hold no such text; skipped", flush=True)
        else:
            variants[name] = build(vsrc, {name: ("pointer_mha.cu", ())}, shims,
                                   os.path.join(vdir, "lib"))[name]

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    out = {}

    def report(name, ms, **extra):
        out[name] = dict(ms=ms, **extra)
        print(f"{name}: {ms} ms {extra if extra else ''}", flush=True)

    # ---- the attention forward whose loop the other two share: at the
    # 64-pair request's shape, with the training forward's lse, and over the
    # partial-3072 request's kept keys (2353 of 2368)
    scale = DK ** -0.5
    flash = libs["flash_packed"].shim
    for b, nq, nk, nk_valid, with_lse in ((64, 1024, 1024, 1024, False),
                                          (64, 1024, 1024, 1024, True),
                                          (8, 3072, 2368, 2353, False)):
        q, k, v = randn(b, nq, D), randn(b, nk, D), randn(b, nk, D)
        k[:, nk_valid:] = 0
        v[:, nk_valid:] = 0
        o = torch.empty_like(q)
        lse = torch.empty(b, H, nq, device=dev) if with_lse else None
        _call(flash, q, k, v, o, lse, b, nq, nk, nk_valid, H, scale)
        torch.cuda.synchronize()
        want = attention.flash_mha_packed_ref(q, k, v, scale, H, nk_valid=nk_valid)
        err = (o.float() - want.float()).abs().max().item()
        if err > 2e-2:
            raise RuntimeError(f"flash_packed B={b} Nq={nq} through the shim: max abs err {err}")
        report(f"flash_packed_B{b}_Nq{nq}_Nk{nk}_valid{nk_valid}{'_lse' if with_lse else ''}",
               time_ms(lambda: _call(flash, q, k, v, o, lse, b, nq, nk, nk_valid, H, scale)),
               max_abs_err=err)

    # ---- column masses: the row logsumexps and the mass pass
    n = 3072
    for b in (8, 2):
        q, k = randn(b, n, D), randn(b, n, D)
        lse = torch.empty(b, H, n, device=dev)
        cm = torch.empty(b, H, n, device=dev)
        full = libs["colmass"].shim
        _call(full, q, k, lse, cm, b, n, n, H, scale)
        torch.cuda.synchronize()
        err = rel_err(cm, colmass.softmax_colmass_ref(q, k, scale, H))
        if err > 1e-3:
            raise RuntimeError(f"softmax_colmass B={b} through the shim: relative err {err}")
        report(f"softmax_colmass_B{b}",
               time_ms(lambda: _call(full, q, k, lse, cm, b, n, n, H, scale)), rel_err=err)
        lib = libs.get("colmass_lse_only")
        if lib is not None:
            report(f"softmax_colmass_lse_pass_B{b}",
                   time_ms(lambda: _call(lib.shim, q, k, lse, cm, b, n, n, H, scale)))
            report(f"softmax_colmass_mass_pass_B{b}",
                   out[f"softmax_colmass_B{b}"]["ms"] - out[f"softmax_colmass_lse_pass_B{b}"]["ms"],
                   note="the whole less the lse pass")

    # ---- the fused attention sublayer: projections, attention, out projection
    w = [t for _ in range(4) for t in (randn(D, D, scale=D ** -0.5), randn(D, scale=0.1))]
    wq, bq, wk, bk, wv, bv, wo, bo = w
    in_w = torch.cat([wq.t(), wk.t(), wv.t()]).contiguous()
    in_b = torch.cat([bq, bk, bv])
    out_w = wo.t().contiguous()
    n = 1024
    for b in (64, 8):
        yq, ykv = randn(b, n, D), randn(b, n, D)
        for kind, kv in (("cross", ykv), ("self", yq)):
            scr = [torch.empty_like(yq), torch.empty_like(kv), torch.empty_like(kv)]
            o = torch.empty_like(yq)

            def call(lib):
                _call(lib.shim, yq, kv, *w, *scr, o, b, n, n, D, H)

            call(libs["fused_mha"])
            torch.cuda.synchronize()
            want = pointer.fused_mha_ref(yq, kv, *w, H)
            err = rel_err(o.float(), want.float())
            if err > 2 ** -6:
                raise RuntimeError(f"fused_mha {kind} B={b} through the shim: relative err {err}")
            name = f"fused_mha_{kind}_B{b}"
            report(name, time_ms(lambda: call(libs["fused_mha"])), rel_err=err)
            for part in ("projections_only", "no_out_projection"):
                lib = libs.get(f"fused_mha_{part}")
                if lib is not None:
                    report(f"{name}_{part}", time_ms(lambda: call(lib)))
            for vname, lib in variants.items():
                report(f"{name}_{vname}", time_ms(lambda: call(lib)))
            if three and f"{name}_no_out_projection" in out:
                report(f"{name}_attention", out[f"{name}_no_out_projection"]["ms"]
                       - out[f"{name}_projections_only"]["ms"], note="difference of cut builds")
                report(f"{name}_out_projection", out[name]["ms"]
                       - out[f"{name}_no_out_projection"]["ms"], note="difference of cut builds")

            def library():
                return F.multi_head_attention_forward(
                    yq.transpose(0, 1), kv.transpose(0, 1), kv.transpose(0, 1), D, H, in_w,
                    in_b, None, None, False, 0.0, out_w, bo, training=False,
                    need_weights=False)[0]

            lib_err = rel_err(library().transpose(0, 1).float(), want.float())
            if lib_err > 5e-2:
                raise RuntimeError(f"multi_head_attention_forward {kind} B={b}: {lib_err}")
            report(f"{name}_library", time_ms(library), rel_err=lib_err)
            if kind == "self":  # the library's products alone: q, k, v as one, then out
                report(f"{name}_library_projections",
                       time_ms(lambda: F.linear(yq, in_w, in_b)))
                report(f"{name}_library_out_projection",
                       time_ms(lambda: F.linear(yq, out_w, bo)))

    # ---- the training step's backward kernels, statistics in whole tiles
    b = 64
    for n in (int(v) for v in args.sizes.split(",")):
        q, k, v, do = (randn(b, n, D) for _ in range(4))
        o, lse = attention.flash_mha_packed_ref(q, k, v, scale, H, return_lse=True)
        lse_t = F.pad(lse, (0, -n % 64), value=float("inf"))
        delta = torch.empty_like(lse_t)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

        def flash_bwd():
            _call(libs["flash_bwd"].shim, q, k, v, o, do, lse_t, delta, dq, dk, dv, b, n, n, H,
                  scale)

        flash_bwd()
        torch.cuda.synchronize()
        want = attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, scale, H)
        errs = [rel_err(gv.float(), wv.float()) for gv, wv in zip((dq, dk, dv), want)]
        if max(errs) > 1e-2:
            raise RuntimeError(f"flash_bwd N={n} through the shim: relative errors {errs}")
        report(f"flash_bwd_B{b}_N{n}", time_ms(flash_bwd), rel_errs=errs)
        del q, k, v, do, o, want

        se, te = randn(b, n, E, scale=E ** -0.5), randn(b, n, E, scale=E ** -0.5)
        tgt = torch.rand(b, n, 3, generator=g, device=dev) * 2 - 1
        corr, lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
        dcorr = torch.randn(b, n, 3, generator=g, device=dev)
        lse_t = F.pad(lse, (0, -n % 64), value=float("inf"))
        keys = torch.empty(b, n + -n % 64, 4, device=dev)
        rows = torch.empty_like(keys)
        d_src, d_tgt_emb = torch.empty(b, n, E, device=dev), torch.empty(b, n, E, device=dev)
        d_tgt = torch.empty(b, n, 3, device=dev)

        def vcp_bwd():
            _call(libs["vcp_bwd"].shim, se, te, tgt, corr, dcorr, lse_t, keys, rows, d_src,
                  d_tgt_emb, d_tgt, b, n, n, E)

        vcp_bwd()
        torch.cuda.synchronize()
        want = vcp.vcp_bwd_ref(se, te, tgt, corr, lse, dcorr)
        errs = [rel_err(gv, wv) for gv, wv in zip((d_src, d_tgt_emb, d_tgt), want)]
        if max(errs) > 1e-2:
            raise RuntimeError(f"vcp_bwd N={n} through the shim: relative errors {errs}")
        report(f"vcp_bwd_B{b}_N{n}", time_ms(vcp_bwd), rel_errs=errs)
        del se, te, tgt, corr, want
    print(json.dumps({"card": smi.strip().splitlines()[0], "sources": args.csrc,
                      "parts": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
