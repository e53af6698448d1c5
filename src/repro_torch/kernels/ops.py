"""Public wrappers around the hand-written CUDA kernels.

Each wrapper prepares its operands (DAC weight programming, batch
flattening, row tables) and then routes on the device of the tensors it is
given: a CPU tensor runs the plain PyTorch version in :mod:`ref`; a CUDA
tensor launches the kernel, and a failed launch raises. There is no
fallback from one to the other.

``LAUNCHES`` counts kernel launches per wrapper (and nothing else), so a
run can show that its path really went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from repro_torch._arith import div
from repro_torch.core import adc as adc_mod
from repro_torch.core import projection as proj_mod
from repro_torch.core import pwm as pwm_mod
from repro_torch.kernels import _build, ref

LAUNCHES = {"ip2_project": 0, "quant_matmul": 0, "ip2_fused_embed": 0,
            "ip2_project_sparse": 0, "ip2_ragged": 0, "delta_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class IP2KernelParams:
    """Static analog-model constants of the projection epilogue."""

    n2: int                      # true pixels/patch (charge-share divisor)
    pwm_levels: int = 64         # 6-bit PWM
    droop: float = 1.0           # summer retention factor
    v_ref: float = 0.0
    nl_kind: str = "none"        # "none" | "relu" (2T stage), clip at v_sat
    v_sat: float = 1.0
    adc_bits: int = 8
    adc_vmin: float = -1.0
    adc_vmax: float = 1.0
    adc_enable: bool = True
    adc_out_codes: bool = False  # emit int codes (the wire format)
    readout: str = "adc"         # "adc" | "sign"

    def __post_init__(self):
        if self.readout not in ("adc", "sign"):
            raise ValueError(f"unknown readout mode {self.readout!r}")

    def adc_spec(self) -> adc_mod.ADCSpec:
        return adc_mod.ADCSpec(bits=self.adc_bits, v_min=self.adc_vmin,
                               v_max=self.adc_vmax)

    @property
    def out_dtype(self) -> torch.dtype:
        if self.readout == "sign":
            return torch.int8  # {0,1}; the wrapper re-types to bool
        if self.adc_enable and self.adc_out_codes:
            return self.adc_spec().code_dtype
        return torch.float32


def kernel_params_from_spec(spec: proj_mod.PatchSpec, adc=None, codes: bool = False,
                            readout: str = "adc") -> IP2KernelParams:
    if codes and adc is None:
        raise ValueError("codes=True requires an ADCSpec (the codes ARE the ADC output)")
    if readout == "sign" and codes:
        raise ValueError("readout='sign' emits the 1-bit sign wire; the int "
                         "code wire (codes=True) only exists on the ADC readout")
    return IP2KernelParams(
        readout=readout,
        n2=spec.pixels_per_patch,
        pwm_levels=spec.quant.pwm_levels,
        droop=spec.summer.droop_factor(),
        v_ref=spec.summer.v_ref,
        nl_kind=spec.nl.kind if spec.nl.kind in ("relu",) else "none",
        v_sat=spec.nl.v_sat,
        adc_bits=adc.bits if adc is not None else 8,
        adc_vmin=adc.v_min if adc is not None else -1.0,
        adc_vmax=adc.v_max if adc is not None else 1.0,
        adc_enable=adc is not None,
        adc_out_codes=codes,
    )


class ProgrammedWeights(NamedTuple):
    """DAC-programmed projection weights, computed once at deploy time."""

    w_q: torch.Tensor     # (M, N2) float weights ON the DAC grid
    scale: torch.Tensor   # per-output scale (diagnostic; kernels ignore it)


def program_weights(weights, spec: proj_mod.PatchSpec) -> ProgrammedWeights:
    """Run the weight-DAC quantisation once; idempotent."""
    if isinstance(weights, ProgrammedWeights):
        return weights
    w_q, scale = pwm_mod.quantize_weights(weights, spec.quant)
    return ProgrammedWeights(w_q=w_q, scale=scale)


def _dac_weights(weights, spec: proj_mod.PatchSpec) -> torch.Tensor:
    if isinstance(weights, ProgrammedWeights):
        return weights.w_q
    return pwm_mod.quantize_weights(weights, spec.quant)[0]


# ---------------------------------------------------------------------------
# device routing and the C interface
# ---------------------------------------------------------------------------

class _Epilogue(ctypes.Structure):
    """Mirror of ``ip2::Epilogue`` (csrc/ip2_common.cuh). Each float field
    is a Python double rounded to float32 once, on assignment."""

    _fields_ = [
        ("pwm_n", ctypes.c_float), ("pwm_inv_n", ctypes.c_float),
        ("acc_scale", ctypes.c_float), ("v_ref", ctypes.c_float),
        ("relu", ctypes.c_int), ("v_sat", ctypes.c_float),
        ("mode", ctypes.c_int), ("adc_vmin", ctypes.c_float),
        ("adc_vmax", ctypes.c_float), ("adc_lsb", ctypes.c_float),
        ("adc_half", ctypes.c_float),
    ]


_CODES, _DEQUANT, _NOADC, _SIGN = 0, 1, 2, 3


def _readout_mode(p: IP2KernelParams) -> int:
    if p.readout == "sign":
        return _SIGN
    if not p.adc_enable:
        return _NOADC
    return _CODES if p.adc_out_codes else _DEQUANT


def _epilogue(p: IP2KernelParams) -> _Epilogue:
    spec = p.adc_spec()
    n = p.pwm_levels - 1
    return _Epilogue(
        pwm_n=n, pwm_inv_n=1.0 / n, acc_scale=p.droop / p.n2, v_ref=p.v_ref,
        relu=int(p.nl_kind == "relu"), v_sat=p.v_sat, mode=_readout_mode(p),
        adc_vmin=spec.v_min, adc_vmax=spec.v_max, adc_lsb=spec.lsb,
        adc_half=spec.levels // 2,
    )


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_EP = ctypes.POINTER(_Epilogue)
_ARGTYPES = {
    "ip2_project": [_P, _P, _P, _P, _I, _I, _I, _I, _EP, _P],
    "quant_matmul": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "ip2_fused_embed": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _F, _I, _P, _EP, _P],
    "ip2_project_sparse": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _EP, _P],
    "ip2_ragged": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _I, _EP, _P],
    "delta_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}
# entry point -> the csrc source that holds it (default: the same name)
_SOURCE = {"ip2_project_sparse": "ip2_ragged"}


def _entry(name: str):
    fn = getattr(_build.load(_SOURCE.get(name, name)), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands (launch the kernel), False for CPU operands
    (plain version); anything else, or mixed devices, raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {dev}")


def _launch(name: str, *args, shape: tuple = ()) -> None:
    """Launch one kernel; a refused launch (a shape the kernel does not
    take, or a CUDA error) raises, naming ``shape`` where given."""
    rc = _entry(name)(*args)
    if rc != 0:
        at = f" at shape {shape}" if shape else ""
        raise RuntimeError(f"{name} kernel launch failed{at}: cudaError {rc}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    """Checks made before a pointer goes to native code."""
    if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need a contiguous {dtype} tensor of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)} "
                         f"(contiguous={t.is_contiguous()})")


def _colv_ptr(bias, p: IP2KernelParams):
    """The per-column epilogue operand: the dequant zero, the bias (no
    ADC), or none (codes, sign). Returns (tensor kept alive, pointer)."""
    mode = _readout_mode(p)
    colv = None
    if mode == _DEQUANT:
        colv = adc_mod.readout_scale_zero(p.v_ref, bias, p.adc_spec())[1].contiguous()
    elif mode == _NOADC:
        colv = bias
    return colv, (None if colv is None else colv.data_ptr())


def _ip2_project_cuda(x, w_t, bias, p: IP2KernelParams) -> torch.Tensor:
    r, k = x.shape
    m = w_t.shape[1]
    _need(x, torch.float32, (r, k), "patches")
    _need(w_t, torch.float32, (k, m), "weights")
    _need(bias, torch.float32, (m,), "bias")
    colv, colv_ptr = _colv_ptr(bias, p)
    out = torch.empty((r, m), dtype=p.out_dtype, device=x.device)
    _launch("ip2_project", x.data_ptr(), w_t.data_ptr(), colv_ptr, out.data_ptr(),
            out.element_size(), r, k, m, ctypes.byref(_epilogue(p)), _stream(x))
    return out


def _ip2_sparse_cuda(table, counts, patches, w_t, bias, p: IP2KernelParams,
                     k: int) -> torch.Tensor:
    """Kernel 1 (``counts`` None: every table row) or kernel 2 (per-slot
    counts over slots of ``k`` rows). ``table`` rows must lie in the patch
    grid (``ip2_project_sparse`` clamps them)."""
    n_rows, kk = patches.shape
    m = w_t.shape[1]
    r = table.shape[0]
    _need(patches, torch.float32, (n_rows, kk), "patches")
    _need(w_t, torch.float32, (kk, m), "weights")
    _need(bias, torch.float32, (m,), "bias")
    _need(table, torch.int32, (r,), "table")
    colv, colv_ptr = _colv_ptr(bias, p)
    out = torch.empty((r, m), dtype=p.out_dtype, device=patches.device)
    ep = ctypes.byref(_epilogue(p))
    if counts is None:
        _launch("ip2_project_sparse", patches.data_ptr(), table.data_ptr(), r, kk,
                w_t.data_ptr(), m, colv_ptr, out.data_ptr(), out.element_size(), ep,
                _stream(patches))
    else:
        s = counts.shape[0]
        _need(counts, torch.int32, (s,), "counts")
        if s * k != r:
            raise ValueError(f"table of {r} rows is not {s} slots x {k}")
        _launch("ip2_ragged", patches.data_ptr(), table.data_ptr(), counts.data_ptr(),
                s, k, kk, w_t.data_ptr(), m, colv_ptr, out.data_ptr(),
                out.element_size(), ep, _stream(patches))
    return out


def _delta_attention_cuda(q, k, v, key_mask, q_counts) -> torch.Tensor:
    b, s, h, dh = q.shape
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _need(t, torch.float32, (b, s, h, dh), name)
    _need(key_mask, torch.bool, (b, s), "key_mask")
    _need(q_counts, torch.int32, (b,), "q_counts")
    out = torch.empty((b, s, h, dh), dtype=torch.float32, device=q.device)
    _launch("delta_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_mask.data_ptr(), q_counts.data_ptr(), b, s, h, dh, out.data_ptr(),
            _stream(q), shape=(b, s, h, dh))
    return out


def _quant_matmul_cuda(a8, s_a, w8, s_w) -> torch.Tensor:
    """``a8`` holds int8 codes, or the int16 / int32 codes of a 9- to 16- /
    17- to 32-bit ADC; the sums are the reference's int32 sums, which wrap
    modulo 2^32, at every K."""
    r, k = a8.shape
    n = w8.shape[1]
    if a8.dtype not in (torch.int8, torch.int16, torch.int32):
        raise ValueError(f"quant_matmul kernel: {a8.dtype} codes; it takes int8, "
                         "int16 and int32 codes (ADCs of up to 32 bits)")
    _need(a8, a8.dtype, (r, k), "a8")
    _need(w8, torch.int8, (k, n), "w8")
    _need(s_a, torch.float32, (r,), "s_a")
    _need(s_w, torch.float32, (n,), "s_w")
    out = torch.empty((r, n), dtype=torch.float32, device=a8.device)
    _launch("quant_matmul", a8.data_ptr(), a8.element_size(), s_a.data_ptr(),
            w8.data_ptr(), s_w.data_ptr(), out.data_ptr(), r, k, n, _stream(a8),
            shape=(r, k, n))
    return out


def _fused_embed_cuda(table, counts, patches, w_t, w8, s_w, s_a: float,
                      p: IP2KernelParams, k: int) -> torch.Tensor:
    """``table`` rows must lie in the patch grid (``ip2_fused_embed``
    clamps them; checking here would cost a device sync per call). Codes of
    up to 8 bits run as int8, of 9 to 16 bits as int16 and of 17 to 32 bits
    as int32; the embed sums wrap modulo 2^32 as the reference's do. Any M
    is taken: past the room of a block's shared memory for the bank's code
    tile the kernel walks M in chunks (an ADC wider than 32 bits raises,
    naming the shape)."""
    n_rows, kk = patches.shape
    m = w_t.shape[1]
    d = w8.shape[1]
    s = counts.shape[0]
    _need(patches, torch.float32, (n_rows, kk), "patches")
    _need(w_t, torch.float32, (kk, m), "weights")
    _need(table, torch.int32, (s * k,), "table")
    _need(counts, torch.int32, (s,), "counts")
    _need(w8, torch.int8, (m, d), "w8")
    _need(s_w, torch.float32, (d,), "s_w")
    out = torch.empty((s * k, d), dtype=torch.float32, device=patches.device)
    _launch("ip2_fused_embed", patches.data_ptr(), table.data_ptr(),
            counts.data_ptr(), s, k, kk, w_t.data_ptr(), m, w8.data_ptr(),
            s_w.data_ptr(), s_a, d, out.data_ptr(),
            ctypes.byref(_epilogue(p)), _stream(patches), shape=(s * k, kk, m, d))
    return out


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def ip2_project(
    patches: torch.Tensor,          # (..., P, N2) in [0,1]
    weights,                        # (M, N2) float (pre-DAC) or ProgrammedWeights
    spec: proj_mod.PatchSpec,
    adc=None,
    bias: torch.Tensor | None = None,
    codes: bool = False,
    readout: str = "adc",
) -> torch.Tensor:
    """Kernel-backed analog projection with the fused readout: (..., P, M)
    float32, int codes (``codes=True``; the bias then lives in the wire's
    ``zero``) or the bool sign wire (``readout="sign"``)."""
    w_q = _dac_weights(weights, spec)
    m, n2 = w_q.shape
    lead = patches.shape[:-1]
    flat = patches.reshape(-1, n2).to(torch.float32)
    b = (torch.zeros((m,), dtype=torch.float32, device=w_q.device)
         if bias is None else bias.to(torch.float32))
    w_t = w_q.T.to(torch.float32)
    params = kernel_params_from_spec(spec, adc, codes, readout)
    if _on_cuda(flat, w_t, b):
        out = _ip2_project_cuda(flat.contiguous(), w_t.contiguous(),
                                b.contiguous(), params)
    else:
        out = ref.ip2_project_ref(flat, w_t, b, params)
    if readout == "sign":
        out = out.to(torch.bool)
    return out.reshape(*lead, m)


def ip2_conv(
    frame: torch.Tensor,            # (H, W) or (B, H, W) pixel voltages in [0,1]
    weights,                        # (C, K²) float (pre-DAC) or ProgrammedWeights
    conv: proj_mod.ConvSpec,
    adc=None,
    bias: torch.Tensor | None = None,
    codes: bool = False,
    readout: str = "adc",
) -> torch.Tensor:
    """Conv-in-pixel mode: the frame's strided K×K windows
    (``extract_windows``, a plain PyTorch gather) are the patches and the C
    output channels the vectors of :func:`ip2_project`, so on CUDA tensors
    the projection kernel runs with its float, code or sign readout.
    Returns (..., gh·gw, C) in row-major window order. What the weight DAC
    costs per frame is priced by ``power.conv_frame_events``."""
    windows = proj_mod.extract_windows(frame, conv.kernel, conv.stride)
    return ip2_project(windows, weights, conv.patch_spec(), adc=adc, bias=bias,
                       codes=codes, readout=readout)


def _identity_indices(patches: torch.Tensor) -> torch.Tensor:
    """(..., j, N2) gathered patches -> (..., j) identity row indices."""
    j = patches.shape[-2]
    return torch.arange(j, dtype=torch.int32, device=patches.device).expand(
        *patches.shape[:-2], j)


def _ragged_tables(indices: torch.Tensor, n_patches: int, row_counts):
    """Slot-major tables of the ragged kernels: ``table`` (S·k,) int32 dense
    row indices (batch offset folded in, clamped into the grid) and
    ``counts`` (S,) int32 real rows per slot, clipped to [0, k] (k for
    every slot when ``row_counts`` is None)."""
    lead = indices.shape[:-1]
    k = indices.shape[-1]
    idx2 = indices.reshape(-1, k).to(torch.int32)
    batch = idx2.shape[0]
    dev = idx2.device
    offsets = torch.arange(batch, dtype=torch.int32, device=dev) * n_patches
    table = torch.clamp(idx2 + offsets[:, None], 0, batch * n_patches - 1)
    table = table.reshape(-1).to(torch.int32).contiguous()
    if row_counts is None:
        counts = torch.full((batch,), k, dtype=torch.int32, device=dev)
    else:
        counts = torch.broadcast_to(torch.as_tensor(row_counts, device=dev), lead)
        counts = torch.clamp(counts.reshape(-1).to(torch.int32), 0, k)
    return table, counts.to(torch.int32).contiguous()


def ip2_project_sparse(
    patches: torch.Tensor,          # (..., P, N2) dense patch grid in [0,1]
    weights,                        # (M, N2) float (pre-DAC) or ProgrammedWeights
    indices: torch.Tensor,          # (..., k) active patch indices
    spec: proj_mod.PatchSpec,
    adc=None,
    bias: torch.Tensor | None = None,
    codes: bool = False,
    readout: str = "adc",
    row_counts=None,                # (...,) int real rows per slot, or None
) -> torch.Tensor:
    """Projection of only the ``indices`` rows of the dense patch grid,
    with the fused readout of :func:`ip2_project`: (..., k, M) in the order
    of ``indices``. With ``row_counts`` only the leading ``row_counts``
    rows of each slot are computed (the ragged kernel) and the rest are
    zero; without, every row is (the sparse kernel), bitwise the ragged
    result at full counts."""
    w_q = _dac_weights(weights, spec)
    m, n2 = w_q.shape
    lead = patches.shape[:-2]
    if indices.shape[:-1] != lead:
        raise ValueError(f"indices lead {tuple(indices.shape[:-1])} != patches "
                         f"lead {tuple(lead)}")
    k = indices.shape[-1]
    flat_p = patches.reshape(-1, n2).to(torch.float32)
    table, counts = _ragged_tables(indices, patches.shape[-2], row_counts)
    if row_counts is None:
        counts = None
    b = (torch.zeros((m,), dtype=torch.float32, device=w_q.device)
         if bias is None else bias.to(torch.float32))
    w_t = w_q.T.to(torch.float32)
    params = kernel_params_from_spec(spec, adc, codes, readout)
    if _on_cuda(flat_p, w_t, b, table):
        out = _ip2_sparse_cuda(table, counts, flat_p.contiguous(), w_t.contiguous(),
                               b.contiguous(), params, k)
    else:
        out = ref.ip2_project_sparse_ref(table, counts, flat_p, w_t, b, params, k)
    if readout == "sign":
        out = out.to(torch.bool)
    return out.reshape(*lead, k, m)


def fused_adc_conversions(n_rows, spec: proj_mod.PatchSpec, adc=None):
    """ADC conversions one projection call performs for ``n_rows`` real
    rows: M per row when a fused ADC epilogue runs (``adc`` given), else 0
    (the caller's own readout converts, and counts)."""
    if adc is None:
        return 0 * n_rows
    return n_rows * spec.n_vectors


def fused_sign_comparisons(n_rows, spec: proj_mod.PatchSpec):
    """Comparator firings of one sign-readout projection call: one per
    (real row, vector), priced as ``sign_comparisons``."""
    return n_rows * spec.n_vectors


def _adapter(spec: proj_mod.PatchSpec, programmed, **readout):
    """A frontend ``ProjectFn`` over kernel 6 (no ``row_counts``) or the
    ragged kernel 2 (with them: rows past a slot's count come back zero),
    with the fused ``readout`` (``ip2_project``'s keywords). ``programmed``
    (``ProgrammedWeights``) replaces the weights it is handed."""

    def fn(patches, weights, _spec, row_counts=None):
        w = programmed if programmed is not None else weights
        if row_counts is None:
            return ip2_project(patches, w, _spec, **readout)
        return ip2_project_sparse(patches, w, _identity_indices(patches), _spec,
                                  row_counts=row_counts, **readout)

    fn.supports_row_counts = True
    return fn


def ip2_project_fn(spec: proj_mod.PatchSpec, programmed=None):
    """Frontend ``ProjectFn`` with no fused ADC: the analog output, for the
    frontend's own readout (dense mode and the float wire)."""
    fn = _adapter(spec, programmed, adc=None)
    fn.frame_conversions = lambda n_rows: fused_adc_conversions(n_rows, spec)
    return fn


def ip2_codes_fn(spec: proj_mod.PatchSpec, adc, programmed=None):
    """Frontend ``ProjectFn`` whose output is the wire format: int codes
    straight from the kernel's fused ADC epilogue (``emits_codes``)."""
    fn = _adapter(spec, programmed, adc=adc, codes=True)
    fn.emits_codes = True
    fn.frame_conversions = lambda n_rows: fused_adc_conversions(n_rows, spec, adc)
    return fn


def ip2_sign_fn(spec: proj_mod.PatchSpec, programmed=None):
    """Frontend ``ProjectFn`` whose output is the 1-bit sign wire: bool
    comparator bits from the kernel's ADC-less epilogue (``emits_sign``)."""
    fn = _adapter(spec, programmed, readout="sign")
    fn.emits_sign = True
    fn.frame_conversions = lambda n_rows: fused_adc_conversions(n_rows, spec)
    fn.frame_sign_comparisons = lambda n_rows: fused_sign_comparisons(n_rows, spec)
    return fn


def quant_matmul_pre(
    a8: torch.Tensor,               # (..., K) int8 pre-quantized activations
    s_a,                            # (...,) float32 per-row scales (or scalar)
    w8: torch.Tensor,               # (K, N) int8 codes
    s_w: torch.Tensor,              # (N,) scales
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """y = (a8 @ w8) * s_a * s_w for already-quantised activations (the
    edge-ADC codes): no second rounding of the activations."""
    k, n = w8.shape
    lead = a8.shape[:-1]
    flat = a8.reshape(-1, k)
    s_flat = torch.broadcast_to(
        torch.as_tensor(s_a, dtype=torch.float32, device=flat.device), lead
    ).reshape(-1).contiguous()
    s_w = s_w.to(torch.float32)
    if _on_cuda(flat, s_flat, w8, s_w):
        out = _quant_matmul_cuda(flat.contiguous(), s_flat, w8.contiguous(),
                                 s_w.contiguous())
    else:
        out = ref.quant_matmul_ref(flat, s_flat, w8, s_w)
    return out.to(out_dtype).reshape(*lead, n)


def quant_matmul(
    a: torch.Tensor,                # (..., K) float activations
    w8: torch.Tensor,               # (K, N) int8 codes
    s_w: torch.Tensor,              # (N,) scales
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """y = a @ dequant(w8): quantises ``a`` per row to int8 on the host
    (``ref.quantize_activations_ref``), then :func:`quant_matmul_pre`.
    Activations that already are codes call ``quant_matmul_pre``."""
    k = w8.shape[0]
    lead = a.shape[:-1]
    a8, s_a = ref.quantize_activations_ref(a.reshape(-1, k))
    out = quant_matmul_pre(a8, s_a, w8, s_w, out_dtype=out_dtype or a.dtype)
    return out.reshape(*lead, w8.shape[1])


def quantize_weights_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> int8 codes + per-column scale (offline weight prep)."""
    amax = torch.amax(torch.abs(w), dim=0)
    scale = div(torch.clamp_min(amax, 1e-12), 127.0)
    w8 = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return w8, scale.to(torch.float32)


def ip2_fused_embed(
    patches: torch.Tensor,          # (..., P, N2) dense patch grid in [0,1]
    weights,                        # (M, N2) float (pre-DAC) or ProgrammedWeights
    indices: torch.Tensor,          # (..., k) active patch indices
    spec: proj_mod.PatchSpec,
    adc,                            # ADCSpec — the fused seam is code space
    w8: torch.Tensor,               # (M, D) int8 embed weight codes
    s_w: torch.Tensor,              # (D,) float32 per-column embed scales
    row_counts=None,                # (...,) int real rows per slot, or None
) -> torch.Tensor:
    """Projection + fused ADC + the w8a8 embed in one kernel: (..., k, D)
    float32 ``(codes @ w8) * lsb * s_w``, bit for bit the staged
    ``ip2_project(codes=True)`` -> ``quant_matmul_pre`` pair. Rows at or
    past their slot's count are zero."""
    if adc is None:
        raise ValueError("ip2_fused_embed requires an ADCSpec: the fused seam "
                         "only exists in ADC code space")
    w_q = _dac_weights(weights, spec)
    m, n2 = w_q.shape
    if w8.shape[0] != m:
        raise ValueError(f"embed rows {w8.shape[0]} != n_vectors {m}")
    lead = patches.shape[:-2]
    n_patches = patches.shape[-2]
    if indices.shape[:-1] != lead:
        raise ValueError(f"indices lead {tuple(indices.shape[:-1])} != patches "
                         f"lead {tuple(lead)}")
    k = indices.shape[-1]
    flat_p = patches.reshape(-1, n2).to(torch.float32)
    table, counts = _ragged_tables(indices, n_patches, row_counts)
    w_t = w_q.T.to(torch.float32)
    s_w = s_w.to(torch.float32)
    params = kernel_params_from_spec(spec, adc, codes=True)
    if _on_cuda(flat_p, w_t, w8, s_w):
        out = _fused_embed_cuda(table, counts, flat_p.contiguous(), w_t.contiguous(),
                                w8.contiguous(), s_w.contiguous(), adc.lsb,
                                params, k)
    else:
        out = ref.ip2_fused_embed_ref(table, counts, flat_p, w_t, w8, s_w, params, k)
    return out.reshape(*lead, k, w8.shape[1])


def fused_embed_zero_term(zero, w8: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """The selection-independent ``zero @ dequant(w8)`` term the fused kernel
    leaves to the caller (the same expression as the staged embed)."""
    return zero @ (w8.to(torch.float32) * s_w[None, :])


def delta_attention(
    attn_params: dict,
    h: torch.Tensor,                # (B, S, d) normed layer input
    token_valid: torch.Tensor,      # (B, S) bool key mask
    q_counts: torch.Tensor,         # (B,) int stale prefix length
    n_heads: int,
) -> torch.Tensor:
    """Ragged stale-prefix attention of the delta-gated backend: the Q/K/V
    and output projections in plain einsums (as the reference leaves them
    outside its kernel), the kernel scoring only the first ``q_counts``
    query rows of each slot against every key. Rows past a slot's count
    come back zero (their attention output is 0 before the output
    projection)."""
    del n_heads  # carried by the projection weights' shapes
    a = attn_params
    q = torch.einsum("bsd,dhk->bshk", h, a["wq"]) + a["bq"]
    k = torch.einsum("bsd,dhk->bshk", h, a["wk"]) + a["bk"]
    v = torch.einsum("bsd,dhk->bshk", h, a["wv"]) + a["bv"]
    counts = q_counts.to(torch.int32)
    if _on_cuda(q, k, v, token_valid, counts):
        o = _delta_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                  token_valid.contiguous(), counts.contiguous())
    else:
        o = ref.delta_attention_ref(q, k, v, token_valid, counts)
    return torch.einsum("bshk,hkd->bsd", o, a["wo"])
