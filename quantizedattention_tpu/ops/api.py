"""Public attention APIs with JAX AD integration.

The JAX counterpart of the reference's torch.autograd.Function layer
(SURVEY.md §1 L3):

  flash_attention_bf16  <- flash_atten_2_bf16 / FlashAttention_2_BF16_
                           autograd_function (attention_bf16.py:16-105):
                           corrected-bf16 forward, fp32 FA2 backward;
                           residuals (q, k, v, O, lse) exactly as the
                           reference saves (attention_bf16.py:56).
  sage_attention_int8   <- sage_attention_3_int8 / SageAttention3_Int8_
                           autograd_function (attention_int8.py:20-95,434-451):
                           K-smoothing, int8 forward; backward re-uses the
                           forward's int8 blocks + scales + k_mean
                           (attention_int8.py:58-65).
  attention_jvp         <- helion_attention_jvp_forward_fp32 consumed by
                           torch fwd-mode AD (attention_jvp.py:24, README:19-22):
                           here a jax.custom_jvp whose tangent rule is the
                           fused JVP kernel.

Block configs are resolved *before* the custom-AD boundary so forward and
backward share one static tiling (the reference threads (Bq,Bkv) through
ctx.args at runtime, attention_int8.py:65 — JAX requires them static).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.custom_transpose import custom_transpose

from quantizedattention_tpu.ops.flash_bwd import flash_attention_bwd
from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd
from quantizedattention_tpu.ops.int8_bwd import int8_attention_bwd
from quantizedattention_tpu.ops.int8_fwd import int8_attention_fwd
from quantizedattention_tpu.ops.jvp_bwd import attention_jvp_bwd
from quantizedattention_tpu.ops.jvp_fwd import attention_jvp_fwd
from quantizedattention_tpu.ops.jvp_tangent import attention_tangent_fwd
from quantizedattention_tpu.tune.config import BlockConfig, default_block_config
from quantizedattention_tpu.utils.runtime import use_interpret_mode


# --------------------------------------------------------------------------
# bf16: corrected-bf16 forward, fp32 FlashAttention-2 backward
# --------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7))
def _flash_attention_bf16(q, k, v, causal, sm_scale, config, correction, bwd_exact):
    o, _ = flash_attention_fwd(
        q, k, v, causal=causal, sm_scale=sm_scale, config=config, correction=correction
    )
    return o


def _bf16_fwd(q, k, v, causal, sm_scale, config, correction, bwd_exact):
    o, lse = flash_attention_fwd(
        q, k, v, causal=causal, sm_scale=sm_scale, config=config, correction=correction
    )
    return o, (q, k, v, o, lse)


def _bf16_bwd(causal, sm_scale, config, correction, bwd_exact, res, do):
    q, k, v, o, lse = res
    dq, dk, dv = flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale, config=config,
        fast=not bwd_exact,
    )
    return dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype)


_flash_attention_bf16.defvjp(_bf16_fwd, _bf16_bwd)


def flash_attention_bf16(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    correction: str = "eps",
    bwd_exact: bool = False,
) -> jnp.ndarray:
    """Corrected-bf16 flash attention, differentiable.

    q/k/v: [batch, head, tokens, head_dim]. Returns O in f32 — the public
    wrapper drops lse exactly like the reference (attention_bf16.py:101-105).
    correction: "eps" (zero-cost ulp bias, default), "beta" (reference
    rule), or "none".
    bwd_exact: False (default) runs the FA2 backward with bf16 dot operands
    and f32 accumulation on the tensor cores (the usual bf16 FlashAttention
    backward); True runs IEEE f32 dots (the reference's fp32 backward,
    attention_bf16.py:342-344) for oracle-grade gradients.
    correction="none" on a GPU, with the default bf16 backward and no
    explicit config, runs cuDNN's fused attention
    (jax.nn.dot_product_attention): with no correction to apply it is the
    faster of the two on the H100 (PERF.md), forward and backward.
    bwd_exact=True or a config keeps the kernels, on every backend.
    """
    if _takes_cudnn(correction, config, bwd_exact):
        return _cudnn_attention(q, k, v, causal, sm_scale)
    if config is None:
        config = default_block_config("bf16", q.shape[2], k.shape[2], q.shape[3])
    return _flash_attention_bf16(q, k, v, causal, sm_scale, config, correction, bwd_exact)


def _takes_cudnn(correction, config, bwd_exact) -> bool:
    """cuDNN's backward is bf16 and its tiling is its own: it stands in for
    the kernels only when the caller asked for neither exact gradients nor
    a block config."""
    return (correction == "none" and not bwd_exact and config is None
            and not use_interpret_mode())


def _cudnn_attention(q, k, v, causal, sm_scale):
    """cuDNN fused attention on bf16 operands ([b, t, h, d] layout inside),
    f32 out like the kernels; GQA k/v are taken as they are."""
    def bthd(x):
        return jnp.swapaxes(x, 1, 2)

    o = jax.nn.dot_product_attention(
        bthd(q.astype(jnp.bfloat16)), bthd(k.astype(jnp.bfloat16)),
        bthd(v.astype(jnp.bfloat16)), scale=sm_scale, is_causal=causal,
        implementation="cudnn",
    )
    return bthd(o).astype(jnp.float32)


# --------------------------------------------------------------------------
# int8: SageAttention3-style forward + int8 backward (fine-tuning)
# --------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def _sage_attention_int8(q, k, v, causal, sm_scale, config):
    # K-smoothing mean over the token axis (SURVEY.md §2.3 Q3); XLA fuses
    # the subtraction into the quantization pass (the reference smooths
    # outside, attention_int8.py:24, and quantizes in-kernel, :180-195).
    k_mean = jnp.mean(k, axis=-2, keepdims=True)
    o, _, _ = int8_attention_fwd(
        q, k, v, causal=causal, sm_scale=sm_scale, config=config, k_sub=k_mean
    )
    return o


def _int8_fwd_rule(q, k, v, causal, sm_scale, config):
    k_mean = jnp.mean(k, axis=-2, keepdims=True)
    o, lse, residuals = int8_attention_fwd(
        q, k, v, causal=causal, sm_scale=sm_scale, config=config, k_sub=k_mean
    )
    dims = (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3])
    return o, (residuals, k_mean, o, lse, dims)


def _int8_bwd_rule(causal, sm_scale, config, res, do):
    residuals, k_mean, o, lse, dims = res
    dq, dk, dv = int8_attention_bwd(
        residuals, k_mean, o, lse, do, dims,
        causal=causal, sm_scale=sm_scale, config=config,
    )
    return dq, dk, dv


_sage_attention_int8.defvjp(_int8_fwd_rule, _int8_bwd_rule)


def sage_attention_int8(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
) -> jnp.ndarray:
    """INT8 attention (K-smoothed, per-block quantized), differentiable with
    an int8 backward. Returns O in f32 (the reference's wrapper likewise
    returns only O, attention_int8.py:447-451).

    Note the cotangent dtype follows q/k/v; `causal` defaults to False like
    the reference kernel (which has no causal path at all — ours does).
    """
    if config is None:
        config = default_block_config("int8", q.shape[2], k.shape[2], q.shape[3])
    # Primals are carried in f32 (quantization inside produces the int8 path;
    # f32 primals keep the custom_vjp cotangent dtypes uniform).
    return _sage_attention_int8(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32),
        causal, sm_scale, config,
    )


def sage_attention_int8_inference(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    smooth_k: bool = True,
) -> jnp.ndarray:
    """Forward-only INT8 attention: the same quantize-then-kernel forward
    as sage_attention_int8, without keeping residuals; NOT differentiable —
    use sage_attention_int8 when gradients are needed.

    smooth_k=True subtracts the per-head K token-mean before quantization
    (softmax is shift-invariant per row, so no compensation is needed).
    """
    if config is None:
        config = default_block_config("int8", q.shape[2], k.shape[2], q.shape[3])
    k_mean = jnp.mean(k, axis=-2, keepdims=True) if smooth_k else None
    o, _, _ = int8_attention_fwd(
        q, k, v, causal=causal, sm_scale=sm_scale, config=config, k_sub=k_mean
    )
    return o


# --------------------------------------------------------------------------
# JVP: forward-mode attention with fused tangent-O
# --------------------------------------------------------------------------
#
# Two entry points, because JAX's AD machinery cannot give one function all
# three behaviors at once (verified by experiment on jax 0.9):
#
#   attention_jvp            custom_jvp whose tangent map is wrapped in
#                            jax.custom_transpose -> jax.jvp streams the
#                            tangent kernel AND jax.grad works (linearize
#                            transposes the tangent map into flash_bwd).
#                            grad-OF-jvp is not supported on this one
#                            (LinearizeTrace has no custom_transpose rule).
#   attention_value_and_jvp  custom_vjp over (q,k,v,tq,tk,tv) -> (O,tO):
#                            the fused six-accumulator forward kernel, and a
#                            full second-order backward (ops/jvp_bwd) — this
#                            is the rCM-distillation training path (losses
#                            containing tO; reference attention_jvp.py:1-11).


@functools.lru_cache(maxsize=None)
def _make_tangent_map(causal, sm_scale, config):
    """custom_transpose tangent map: (res, (tq,tk,tv)) -> tO.

    The body must stage no array constants (custom_transpose hoists jaxpr
    consts into call args, breaking the transpose's arg unflattening) —
    everything array-valued rides in `res`.
    """

    @custom_transpose
    def t_map(res, lin):
        q, k, v, o, lse = res
        tq, tk, tv = lin
        return attention_tangent_fwd(
            q, k, v, o, lse, tq, tk, tv,
            causal=causal, sm_scale=sm_scale, config=config,
        )

    @t_map.def_transpose
    def t_map_transpose(res, ct):
        q, k, v, o, lse = res
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, ct, causal=causal, sm_scale=sm_scale,
            config=config,
        )
        return dq, dk, dv

    return t_map


@functools.partial(jax.custom_jvp, nondiff_argnums=(3, 4, 5))
def _attention_jvp(q, k, v, causal, sm_scale, config):
    o, _ = flash_attention_fwd(
        q, k, v, causal=causal, sm_scale=sm_scale, config=config, precision="fp32"
    )
    return o


@_attention_jvp.defjvp
def _attention_jvp_rule(causal, sm_scale, config, primals, tangents):
    q, k, v = primals
    tq, tk, tv = tangents
    o, lse = flash_attention_fwd(
        q, k, v, causal=causal, sm_scale=sm_scale, config=config, precision="fp32"
    )
    t_map = _make_tangent_map(causal, sm_scale, config)
    to = t_map(
        jax.core.ShapedArray(o.shape, o.dtype),
        (q, k, v, o, lse),
        (tq, tk, tv),
    )
    return o, to


def attention_jvp(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
) -> jnp.ndarray:
    """fp32 attention supporting BOTH forward-mode AD (streamed tangent
    kernel) and reverse-mode AD (flash fp32 backward via transposition).

    jvp(attention_jvp, (q,k,v), (tq,tk,tv)) computes (O, tO) with the
    flash forward + the given-lse tangent kernel (reference:
    attention_jvp.py:24). jax.grad of losses of the *primal* output works;
    for gradients of losses containing tO (rCM distillation training), use
    `attention_value_and_jvp`.
    """
    if k.shape[1] != q.shape[1]:
        # the fp32 primal (flash fwd) is GQA-native, but the streamed tangent
        # kernels are single-head-count — fail here, coherently, not with a
        # reshape error deep inside jax.jvp
        raise ValueError(
            f"attention_jvp is single-head-count only: q has {q.shape[1]} "
            f"heads but k/v have {k.shape[1]} — jnp.repeat k/v first"
        )
    if config is None:
        config = default_block_config("jvp", q.shape[2], k.shape[2], q.shape[3])
    return _attention_jvp(q, k, v, causal, sm_scale, config)


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9))
def _attention_value_and_jvp(q, k, v, tq, tk, tv, causal, sm_scale, config, fast):
    o, to, _, _ = attention_jvp_fwd(
        q, k, v, tq, tk, tv, causal=causal, sm_scale=sm_scale, config=config,
        fast=fast,
    )
    return o, to


def _pair_fwd(q, k, v, tq, tk, tv, causal, sm_scale, config, fast):
    o, to, lse, mu = attention_jvp_fwd(
        q, k, v, tq, tk, tv, causal=causal, sm_scale=sm_scale, config=config,
        fast=fast,
    )
    return (o, to), (q, k, v, tq, tk, tv, o, to, lse, mu)


def _pair_bwd(causal, sm_scale, config, fast, res, cts):
    q, k, v, tq, tk, tv, o, to, lse, mu = res
    do, dto = cts
    return attention_jvp_bwd(
        q, k, v, tq, tk, tv, o, to, lse, mu, do, dto,
        causal=causal, sm_scale=sm_scale, config=config, fast=fast,
    )


_attention_value_and_jvp.defvjp(_pair_fwd, _pair_bwd)


def attention_value_and_jvp(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    tq: jnp.ndarray,
    tk: jnp.ndarray,
    tv: jnp.ndarray,
    causal: bool = False,
    sm_scale: float | None = None,
    config: BlockConfig | None = None,
    fast: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(O, tO) in one fused streaming pass, differentiable in REVERSE mode
    w.r.t. all six inputs — the rCM-distillation training primitive.

    jax.grad of any loss over (O, tO) runs the second-order flash backward
    (ops/jvp_bwd): exact attention Hessian-vector math, streamed. The
    reference has no counterpart (its JVP kernel is forward-only,
    attention_jvp.py:24); this closes the training loop its own docstring
    describes (attention_jvp.py:1-11).

    fast=True rounds every dot operand (forward and second-order backward)
    to bf16 with f32 accumulation; the default is IEEE fp32 like the
    reference kernel.
    """
    if config is None:
        config = default_block_config("jvp", q.shape[2], k.shape[2], q.shape[3])
    f32 = jnp.float32
    return _attention_value_and_jvp(
        q.astype(f32), k.astype(f32), v.astype(f32),
        tq.astype(f32), tk.astype(f32), tv.astype(f32),
        causal, sm_scale, config, fast,
    )
