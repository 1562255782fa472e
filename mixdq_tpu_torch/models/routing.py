"""Which kernel runs an attention site: the routing of the JAX package's
``mixdq_tpu/models/attention.py:199-509`` for one site, as one function.

The ``*_ok`` gates below are copies of the JAX package's pure shape rules
(``mixdq_tpu/ops/pallas_sec_attention.py``): lane-block head packing,
128-lane offsets and the TPU's VMEM budgets. They choose the route the
reference takes at each shape, so the port runs the same kernel at the
same site; they are not limits of the Hopper kernels, which take every
shape with ``head_dim`` in ``ops.sec_attention.HEAD_DIMS`` (the flash
kernels: ``ops.attention.FLASH_HEAD_DIMS``, SD1.5's 40 / 80 / 160 too,
which ``_lanes`` never sends to a ``sec_attention*`` kernel).

An explicit ``attn_impl`` (``EXPLICIT_ATTN``) sends every site to its
kernel in any mode; the ``sec_attention*`` kernels run under ``'auto'``
only. In fake mode with the q/k/v act quantizers on (``qkv_quant``) every
site runs the einsum chain, which alone materializes the probabilities
that the softmax quantizer reads (``mixdq_tpu/models/attention.py:404``).

The context's kernel options (``QuantCtx.out_fuse`` / ``int8_flash``)
enter as arguments: a site runs its whole-block kernel
(``sec_attention_qkv_out`` at attn1, ``sec_attention_q_out`` at attn2,
``geglu_out_qmatmul`` at ff, ``whole_ff``) only when it is in
``out_fuse`` and the kernel's gate holds, and a flash site at an int8
self-attention runs int8 flash attention unless ``int8_flash`` is
``'off'``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

#: Tq * Tk from which ``attn_impl='auto'`` runs flash attention
#: (``mixdq_tpu/models/attention.py:474-478``)
FLASH_TQ_TK = 2 ** 22

QKV = "sec_attention_qkv"
Q_OUT = "sec_attention_q_out"
SEC_Q = "sec_attention_q"
SEC = "sec_attention"
FLASH = "flash_attention"
QKV_OUT = "sec_attention_qkv_out"
INT8_FLASH = "int8_flash_attention"
INT8QKV_FLASH = "int8qkv_flash_attention"
#: the kernels a route may name
KERNELS = (QKV, Q_OUT, SEC_Q, SEC, FLASH, QKV_OUT, INT8_FLASH, INT8QKV_FLASH)
#: ``QuantCtx.int8_flash`` -> the kernel of an int8 self-attention flash site
_FLASH_BY_MODE = {"off": FLASH, "qk": INT8_FLASH, "qkv": INT8QKV_FLASH}
#: the JAX package's default out-fusion set (``MIXDQ_SEC_OUTFUSE`` unset)
DEFAULT_OUT_FUSE = frozenset({"attn2"})
EINSUM = "einsum"
#: explicit ``attn_impl`` values -> the kernel of every site
EXPLICIT_ATTN = {"flash": FLASH, "int8_flash": INT8_FLASH,
                 "int8qkv_flash": INT8QKV_FLASH}


def _lanes(head_dim: int, heads: int) -> bool:
    """d divides 128 and the heads fill whole 128-lane blocks."""
    return (head_dim <= 128 and 128 % head_dim == 0
            and heads % (128 // head_dim) == 0)


def sec_attention_ok(heads: int, head_dim: int, Tq: int, Tk: int,
                     *offsets: int) -> bool:
    """``pallas_sec_attention.py:81-93``."""
    if not _lanes(head_dim, heads) or any(off % 128 for off in offsets):
        return False
    return Tq * Tk <= 2 ** 20 and Tq % 8 == 0


def _pick_hpp(heads: int, head_dim: int, offsets, budget: int,
              vmem_est) -> int:
    """Largest heads-per-program ``h`` (of the ``nj`` 128-lane blocks)
    that divides ``nj``, keeps every offset ``128 h``-aligned and fits
    ``budget``; 0 when none does."""
    nj = heads // (128 // head_dim)
    for h in range(nj, 0, -1):
        if (nj % h == 0 and all(off % (128 * h) == 0 for off in offsets)
                and vmem_est(128 * h) <= budget):
            return h
    return 0


_BUDGET = int(13.5 * 1024 * 1024)


def sec_attention_q_ok(heads: int, head_dim: int, Tq: int, Tk: int,
                       C_in: int, *offsets: int) -> bool:
    """``pallas_sec_attention.py:187-220`` (with ``_sec_q_pick_hpp``)."""
    if (not _lanes(head_dim, heads) or Tq % 8 or Tq * Tk > 2 ** 20
            or (heads * head_dim) % 128 or C_in % 128):
        return False

    def vmem(w):
        return (2 * Tq * C_in + 2 * C_in * w + 6 * Tq * w + 8 * Tk * w
                + 8 * Tq * Tk + 6 * Tq * w)
    return _pick_hpp(heads, head_dim, offsets, _BUDGET, vmem) > 0


def sec_attention_qkv_ok(heads: int, head_dim: int, T: int, C: int) -> bool:
    """``pallas_sec_attention.py:371-406`` (with ``_sec_qkv_pick_hpp``:
    the three weight panels sit at 0/C/2C, so ``C`` is the offset that
    must stay aligned)."""
    if (not _lanes(head_dim, heads) or T % 8 or T * T > 2 ** 20
            or heads * head_dim != C or C % 128):
        return False

    def vmem(w):
        return (2 * T * C + 6 * C * w + 6 * T * w + 12 * T * w + 8 * T * T
                + 6 * T * w)
    return _pick_hpp(heads, head_dim, (C,), _BUDGET, vmem) > 0


def _pick_row_chunk(Tq: int, Tk: int) -> int:
    """``pallas_sec_attention.py:317-323``."""
    c = Tq
    while c > 8 and c % 2 == 0 and c * Tk * 4 > (1 << 20):
        c //= 2
    return c


def sec_attention_q_out_ok(heads: int, head_dim: int, Tq: int, Tk: int,
                           C_in: int, *offsets: int) -> bool:
    """``pallas_sec_attention.py:777-811`` (with
    ``_sec_q_out_pick_hpp``)."""
    if (not _lanes(head_dim, heads) or Tq % 8 or (heads * head_dim) % 128
            or C_in % 128):
        return False
    C = heads * head_dim
    rc = _pick_row_chunk(Tq, Tk)

    def vmem(w):
        return (2 * Tq * C_in + 2 * C_in * w + 6 * Tq * w + 8 * Tk * w
                + 8 * rc * Tk + Tq * w + 2 * w * C + 4 * Tq * C
                + 4 * Tq * C)
    return _pick_hpp(heads, head_dim, offsets, _BUDGET, vmem) > 0


def sec_attention_qkv_out_ok(heads: int, head_dim: int, T: int,
                             C: int) -> bool:
    """``pallas_sec_attention.py:637-644`` (with
    ``_sec_qkv_out_pick_hpp`` :610-634: the weight panels at 0/C/2C keep
    ``C`` aligned, the logits tile is row-chunked)."""
    if (not _lanes(head_dim, heads) or T % 8 or heads * head_dim != C
            or C % 128):
        return False
    rc = _pick_row_chunk(T, T)

    def vmem(w):
        return (2 * T * C + 6 * C * w + 6 * T * w + 4 * T * w + 8 * rc * T
                + T * w + 2 * w * C + 4 * T * C + 4 * T * C)
    return _pick_hpp(heads, head_dim, (C,), _BUDGET, vmem) > 0


def _geglu_out_pick(M: int, K: int, H: int, C: int) -> Tuple[int, int]:
    """``pallas_qmatmul.py:528-547``: (bm, bn) of the whole-FF kernel
    within a 12 MiB budget, (0, 0) when none fits."""
    Kp = -(-K // 128) * 128
    bn0 = 1280 if M <= 256 else 512

    def vmem(bm, bn):
        return (2 * bm * Kp + 4 * Kp * bn + 12 * bm * bn + bm * bn
                + 2 * bn * C + 4 * bm * C + 4 * bm * C)
    for bm in [m for m in (M, 1024, 512, 256, 128, 64, 32) if m <= M]:
        for bn in (bn0, 512, 256):
            if vmem(bm, bn) <= 12 * 2 ** 20:
                return bm, bn
    return 0, 0


def geglu_out_ok(M: int, K: int, H: int, C: int) -> bool:
    """``pallas_qmatmul.py:550-554``."""
    if C % 128 or M < 8:
        return False
    return _geglu_out_pick(M, K, H, C)[0] > 0


def whole_ff(*, fusable: bool, net2_codes: bool, out_fuse: frozenset,
             M: int, K: int, H: int, C_out: int, ln: bool) -> bool:
    """Whether an ff site runs ``geglu_out_qmatmul``
    (``mixdq_tpu/models/attention.py:627-636``): ``fusable`` (the GEGLU
    kernel runs, ``attention.geglu_fusable``), ``net2_codes`` (``ff.net.2``
    holds unpacked int8 codes), ``'ff'`` in ``out_fuse`` and the gate;
    ``ln``: a deferred pre-LayerNorm folds in, which needs ``K % 128 ==
    0`` and ``C_out == K``."""
    if not (fusable and net2_codes and "ff" in out_fuse):
        return False
    if ln and (K % 128 or C_out != K):
        return False
    return geglu_out_ok(M, K, H, C_out)


class Route(NamedTuple):
    """The kernel of one attention site (one of the names above) and the
    column offsets of q, k and v in their source tensors."""

    kernel: str
    offsets: Tuple[int, int, int]


def attention_route(*, mode: str, attn_impl: str, fused: bool, cross: bool,
                    heads: int, head_dim: int, Tq: int, Tk: int, C_in: int,
                    codes: bool = True, out_entry: bool = True,
                    q_entry: bool = True, compute: str = "int8_sec",
                    fused_codes: bool = True, q_codes: bool = True,
                    out_codes: bool = True,
                    out_fuse: frozenset = DEFAULT_OUT_FUSE,
                    int8_flash: str = "off", qkv_quant: bool = False,
                    small_m: bool = False) -> Route:
    """The JAX package's choice for one attention site.

    ``mode``: the context's ``'fp'`` / ``'fake'`` / ``'int8'``;
    ``qkv_quant``: the context's q/k/v act quantizers are on; ``small_m``:
    its small-M hybrid is on, which turns every ``sec_attention*`` kernel
    off (``mixdq_tpu/models/attention.py:327``, ``:427``); ``compute``: its
    ``deploy_compute`` (the attention kernels run under ``'int8_sec'``
    only); ``fused``: a fused QKV (self) / KV (cross) deploy entry runs
    the projections; ``codes``: the site's input is int8 codes or a
    deferred LayerNorm that can emit them; ``out_entry`` / ``q_entry``:
    ``to_out`` / ``to_q`` have act-quantized (not weight-only) int8
    deploy entries; ``fused_codes`` / ``q_codes`` / ``out_codes``: the
    fused entry / ``to_q`` / ``to_out`` hold unpacked int8 codes, which a
    whole-attention kernel reads itself (``mixdq_tpu/models/attention.py``
    :219-225, :340-347, :355-356). The q/k/v sources: the fused
    ``to_qkv`` output (0/C/2C), ``to_q``'s output and the fused ``to_kv``
    output (0 / 0/C), or three projections (0/0/0)."""
    C = heads * head_dim
    sec = (mode == "int8" and compute == "int8_sec" and attn_impl == "auto"
           and not small_m)
    if fused and not cross:
        offsets = (0, C, 2 * C)
    else:
        offsets = (0, 0, C) if fused else (0, 0, 0)
    if sec and fused and codes and out_entry:
        if not cross and fused_codes:
            if out_codes and "attn1" in out_fuse and \
                    sec_attention_qkv_out_ok(heads, head_dim, Tq, C_in):
                return Route(QKV_OUT, offsets)
            if sec_attention_qkv_ok(heads, head_dim, Tq, C_in):
                return Route(QKV, offsets)
        if cross and q_entry and q_codes:
            if out_codes and "attn2" in out_fuse and sec_attention_q_out_ok(
                    heads, head_dim, Tq, Tk, C_in, 0, C):
                return Route(Q_OUT, offsets)
            if sec_attention_q_ok(heads, head_dim, Tq, Tk, C_in, 0, C):
                return Route(SEC_Q, offsets)
    if sec and out_entry and sec_attention_ok(heads, head_dim, Tq, Tk,
                                              *offsets):
        return Route(SEC, offsets)
    if mode == "fake" and qkv_quant:
        return Route(EINSUM, offsets)
    if attn_impl in EXPLICIT_ATTN:
        return Route(EXPLICIT_ATTN[attn_impl], offsets)
    if attn_impl == "auto" and Tq * Tk >= FLASH_TQ_TK:
        # int8 QK^T / PV at int8 self-attention sites (attention.py:493-498)
        kernel = (_FLASH_BY_MODE[int8_flash] if mode == "int8" and not cross
                  else FLASH)
        return Route(kernel, offsets)
    return Route(EINSUM, offsets)


def act_entry(dp) -> bool:
    """Whether deploy entry ``dp`` is an act-quantized (not weight-only)
    int8 linear entry."""
    return (dp is not None and dp.kind == "linear"
            and dp.scale_inv is not None and not dp.act_off)
