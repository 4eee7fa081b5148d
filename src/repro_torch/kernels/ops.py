"""Public compositions over the kernels, their build and loader, and the
per-kernel launch counters.

Further kernels sit on the SSM / hybrid path and need no composition:
``kernels/ssd.py::ssd_intra`` (``csrc/ssd.cu``, the SSD intra-chunk dual
form inside ``layers/ssm.py::ssd_chunked``) with its gradient
``ssd_intra_bwd`` (``csrc/ssd_bwd.cu``, the backward of ``SSDIntraFn``) and
``kernels/cache_update.py::cache_slot_update`` (``csrc/cache_update.cu``; its
pair form ``cache_kv_update`` is the K and V cache write of
``layers/attention.py::attn_decode``, one launch for both).

Two decode hot paths, twins of ``repro/kernels/ops.py``:

``screened_topk`` — the UNFUSED pipeline: route (``cluster_route``) →
  gather-matmul (``screened_logits``) → sentinel masking → stable top-k over
  the (B, K·V_BLK) candidate row, which round-trips through device memory.

``screened_fused_topk`` — the FUSED pipeline: route → one launch reduces
  each row's candidates on chip (``fused_screened_topk``: blocks per (row,
  slot, part of the tile), merged by the row's last block; from
  ``GROUPED_MIN_ROWS`` rows, blocks per (chunk of (row, slot) pairs of one
  tile, part), the pairs grouped by tile through the routes first); only
  short per-part lists, (B, k) ids/vals and (B,) logZ reach device memory.
  ids/vals are bit-identical to the unfused path. ``screened_fused_sample`` rides the same kernel with
  temperature-scaled Gumbel noise (Gumbel-max ≡ categorical sampling).

``tier_fused_topk`` — the same fused kernel over block ids given directly
  (no route step): the adaptive head's per-tier entry.

Kernels. Each ``csrc/*.cu`` (route, screen, fused_topk, ssd, ssd_bwd,
cache_update)
exposes a plain ``extern "C"`` launcher. ``build_kernels`` compiles each
with its own ``nvcc`` process (all started together) into a shared library
under ``build/repro_torch/`` at the repository root, named by a hash of its
sources and flags, and loads it with ``ctypes``. This happens at the first
launch on a CUDA tensor; importing this module builds nothing. On a CPU
tensor each wrapper runs its plain PyTorch version instead, on a meta
tensor it returns empty results of the kernel's shapes (the dry run,
``launch/dryrun.py``), and on any other device it raises. Under
``launch/op_cost.count_cost`` each wrapper records its kernel as one op
(``kernels/cost.py``).

The route, gather and fused kernels each have a second body for bfloat16
inputs (``csrc/*.cu``, ``*_bf16_kernel``; the weights and h in bfloat16, the
logits float32); its launches count under the kernel's name + ``"_bf16"``.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run resets
it with ``reset_launches`` and reads it to show that the path it drove went
through the kernels. A fused launch on the grouped grid counts under its
kernel's name as any other, after one ``group_rows`` launch, and once more
under ``fused_screened_topk_grouped``, which shows that a path engaged that
grid. A wrapper called while a CUDA graph captures launches
nothing: the serving engine takes the capture's count back out and adds it
again at every replay of the graph (``serving/engine.py::_Graph``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import V_BLK
from repro_torch.kernels.fused_topk import fused_screened_topk
from repro_torch.kernels.ref import NEG_INF, topk_desc
from repro_torch.kernels.route import cluster_route
from repro_torch.kernels.screen import screened_logits

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# library stem → {exported symbol: (argtypes, restype)}
_SIGNATURES = {
    "route": {"l2s_cluster_route": ([_P, _P, _P, _I, _I, _I, _P], _I),
              "l2s_cluster_route_bf16": ([_P, _P, _P, _I, _I, _I, _P], _I)},
    "screen": {"l2s_screened_logits": ([_P] * 5 + [_I] * 5 + [_P], _I),
               "l2s_screened_logits_bf16": ([_P] * 5 + [_I] * 5 + [_P], _I)},
    "fused_topk": {"l2s_fused_screened_topk":
                   ([_P] * 10 + [_I] * 6 + [_P], _I),
                   "l2s_fused_screened_topk_bf16":
                   ([_P] * 10 + [_I] * 6 + [_P], _I),
                   "l2s_fused_screened_topk_grouped":
                   ([_P] * 12 + [_I] * 7 + [_P], _I),
                   "l2s_fused_screened_topk_grouped_bf16":
                   ([_P] * 12 + [_I] * 7 + [_P], _I),
                   "l2s_group_rows": ([_P] * 4 + [_I] * 5 + [_P], _I)},
    "ssd": {"l2s_ssd_intra": ([_P] * 6 + [_I] * 6 + [_P], _I)},
    "ssd_bwd": {"l2s_ssd_intra_bwd": ([_P] * 11 + [_I] * 6 + [_P], _I)},
    "cache_update": {"l2s_cache_slot_update": ([_P] * 3 + [_I] * 4 + [_P], _I),
                     "l2s_cache_kv_update": ([_P] * 5 + [_I] * 4 + [_P], _I)},
}

LAUNCHES: Dict[str, int] = {"cluster_route": 0, "screened_logits": 0,
                            "fused_screened_topk": 0, "ssd_intra": 0,
                            "ssd_intra_bwd": 0, "cache_slot_update": 0,
                            "cluster_route_bf16": 0,
                            "screened_logits_bf16": 0,
                            "fused_screened_topk_bf16": 0, "group_rows": 0,
                            "fused_screened_topk_grouped": 0}
# the bfloat16 kernel bodies of the three L2S kernels, counted apart
BF16 = "_bf16"
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- build and load -----------------------------------------------------------
def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(stem: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def build_kernels() -> Dict[str, Path]:
    """Compile every missing kernel library, one ``nvcc`` per source, all in
    parallel. → {stem: path of its .so}. The ptxas report (registers,
    shared memory, spills) of each build is kept beside it as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {stem: _target(stem) for stem in _SIGNATURES}
    jobs = {}
    for stem, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        jobs[stem] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    failed = []
    for stem, (tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        targets[stem].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, targets[stem])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def _library(stem: str) -> ctypes.CDLL:
    if stem not in _LIBS:
        lib = ctypes.CDLL(str(build_kernels()[stem]))
        for sym, (argtypes, restype) in _SIGNATURES[stem].items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, restype
        lib.l2s_error_string.argtypes = [ctypes.c_int]
        lib.l2s_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return _LIBS[stem]


def launch(kernel: str, stem: str, symbol: str, device: torch.device,
           *args) -> None:
    """Call ``symbol`` of library ``stem`` on the current stream of
    ``device``, raise if it reports a CUDA error, and count the launch
    under ``kernel``."""
    lib = _library(stem)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, symbol)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: "
                           f"{lib.l2s_error_string(rc).decode()})")
    LAUNCHES[kernel] += 1


# -- wrapper checks -----------------------------------------------------------
FLOATS = (torch.float32, torch.bfloat16)
DEVICE_TYPES = ("cuda", "cpu", "meta")


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D tensor on ``device``
    of ``dtype`` (or of one of a tuple of dtypes), and ``device`` one the
    wrappers take: ``cuda`` (the kernel), ``cpu`` (the plain version) or
    ``meta`` (shapes only, the dry run). Float tensors, read as 16-byte
    rows, must also be 16-byte aligned on a GPU."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if device.type not in DEVICE_TYPES:
        raise ValueError(f"{name} is on {device}: the kernels' wrappers take "
                         f"{' / '.join(DEVICE_TYPES)} tensors")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or t.dim() != ndim:
        want = " or ".join(str(x) for x in dtypes)
        raise ValueError(f"{name} must be a {ndim}-D {want} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type == "cuda" and t.dtype in FLOATS and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


# -- compositions -------------------------------------------------------------
def pack_head_blocks(W: torch.Tensor, b: torch.Tensor, v_blk: int = V_BLK):
    """(L, d) softmax weights → (n_blk, v_blk, d) tiles + (n_blk, v_blk),
    in W's and b's own dtype.

    Rows past L get zero weights and a NEG_INF bias so they never win
    top-k (in bfloat16 NEG_INF rounds to about −1.0e30, still a loser)."""
    L, d = W.shape
    pad = -(-L // v_blk) * v_blk - L
    Wp = torch.cat([W, W.new_zeros((pad, d))])
    bp = torch.cat([b, b.new_full((pad,), NEG_INF)])
    return Wp.reshape(-1, v_blk, d).contiguous(), bp.reshape(-1, v_blk).contiguous()


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with u uniform in
    [tiny, 1) as ``jax.random.gumbel`` draws it (other bits: the two
    frameworks' generators differ)."""
    return gumbel_from_uniform(torch.rand(shape, generator=generator,
                                          device=device))


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The Gumbel transform of ``gumbel_noise`` applied to uniform draws
    ``u`` already made (``u`` is left as it was): the serving engine draws
    into a static buffer before each CUDA graph replay and the graph
    transforms it, giving the bits ``gumbel_noise`` gives from the same
    generator state."""
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def _route(v, cand_blocks, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing through the kernel → (clusters (B,) int32, per-row candidate
    block ids (B, K) int32)."""
    cluster = cluster_route(h, v)                                    # (B,)
    return cluster, cand_blocks[cluster.long()].to(torch.int32).contiguous()


def screened_candidate_logits(W_blocks, b_blocks, v, cand_blocks, h
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route + gather-matmul over the routed candidate blocks.

    W_blocks (n_blk, V_BLK, d), b_blocks (n_blk, V_BLK): packed softmax head.
    v (r, d): cluster weights. cand_blocks (r, K) int32, sentinel ≥ n_blk.
    h (B, d). → (logits (B, K·V_BLK) with NEG_INF at sentinel slots,
    word ids (B, K·V_BLK) int32 with sentinel n_blk·V_BLK)."""
    n_blk, v_blk, _ = W_blocks.shape
    B = h.shape[0]
    _, block_ids = _route(v, cand_blocks, h)                         # (B, K)
    raw = screened_logits(W_blocks, b_blocks, h, block_ids)          # (B, K, V)
    valid = ((block_ids >= 0) & (block_ids < n_blk))[..., None]
    logits = torch.where(valid, raw, NEG_INF).reshape(B, -1)
    lane = torch.arange(v_blk, dtype=torch.int32, device=h.device)
    word_ids = torch.where(valid, block_ids[..., None] * v_blk + lane,
                           n_blk * v_blk).reshape(B, -1)
    return logits, word_ids.to(torch.int32)


def screened_topk(W_blocks, b_blocks, v, cand_blocks, h, k: int = 5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unfused L2S prediction: candidate logits → top-k.
    → (word ids (B, k) int32, logits (B, k))."""
    logits, word_ids = screened_candidate_logits(W_blocks, b_blocks, v,
                                                 cand_blocks, h)
    vals, pos = topk_desc(logits, k)
    return torch.gather(word_ids, 1, pos), vals


def screened_fused_topk(W_blocks, b_blocks, v, cand_blocks, h, k: int = 5):
    """Fused L2S prediction: route → on-chip subset softmax + top-k.
    → (word ids (B, k) int32, logits (B, k) f32, logZ (B,) f32); ids/vals
    bit-identical to ``screened_topk``, logZ −∞ (never NaN) for
    all-sentinel rows. The routes go with the ids, so that a wide batch
    takes the kernel's grouped grid."""
    cluster, block_ids = _route(v, cand_blocks, h)
    cand = cand_blocks.to(torch.int32).contiguous()
    return fused_screened_topk(W_blocks, b_blocks, h, block_ids, k=k,
                               cluster=cluster, cand_blocks=cand)


def screened_fused_sample(W_blocks, b_blocks, v, cand_blocks, h,
                          temperature: float = 1.0,
                          generator: Optional[torch.Generator] = None,
                          gumbel: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Fused categorical draw from the candidate softmax (Gumbel-max):
    argmax(logits + T·G) over the routed candidates. ``gumbel`` (B, K, V_BLK)
    supplies G, else it is drawn from ``generator``.
    → (B,) int32 word ids (sentinel n_blk·V_BLK on all-sentinel rows)."""
    cluster, block_ids = _route(v, cand_blocks, h)
    B, K = block_ids.shape
    if gumbel is None:
        gumbel = gumbel_noise((B, K, W_blocks.shape[1]), generator, h.device)
    cand = cand_blocks.to(torch.int32).contiguous()
    ids, _, _ = fused_screened_topk(W_blocks, b_blocks, h, block_ids, k=1,
                                    noise=(temperature * gumbel).contiguous(),
                                    cluster=cluster, cand_blocks=cand)
    return ids[:, 0]


def tier_fused_topk(W_blocks, b_blocks, h, block_ids, k: int = 5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tier fused entry of the adaptive head (``heads/adaptive.py``):
    the fused kernel over candidate blocks given directly — the frequency
    tiers are the routing, so there is no ``cluster_route`` step.
    ``block_ids`` (B, K) int32, sentinel ≥ n_blk; an all-sentinel row (a
    query whose tail gate lost) gives NEG_INF vals, sentinel ids and
    logZ = −∞, never NaN.
    → (packed-row ids (B, k) int32, logits (B, k) f32, logZ (B,) f32);
    callers map packed rows to vocab ids through their tier id map."""
    return fused_screened_topk(W_blocks, b_blocks, h,
                               block_ids.to(torch.int32).contiguous(), k=k)
