"""Flow-matching DiT block built on the JVP attention kernel.

The reference's JVP kernel exists for score-regularized continuous-time
consistency distillation (NVIDIA rCM — attention_jvp.py:1-11): distilling a
flow-matching diffusion model requires du/dt of the network output along the
probability-flow ODE, i.e. a forward-mode derivative THROUGH attention.
`dit_jvp_step` computes (u, du/dt) in one pass, with the attention JVP fused
by the ops/jvp_fwd kernel via the custom_jvp rule on ops.api.attention_jvp.

The model is a minimal adaLN DiT: timestep-conditioned scale/shift/gate
around (non-causal) attention + MLP — enough structure to exercise the
kernel exactly as a diffusion transformer would.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from quantizedattention_tpu.ops.api import attention_jvp, attention_value_and_jvp


@jax.custom_jvp
def _attention_rcm(q, k, v):
    """Attention for the rCM *training* trace: its jvp rule is the fused
    (O, tO) pair kernel, whose custom_vjp is the second-order streamed
    backward — so jax.grad of losses containing du/dt works. (Plain
    jax.grad of THIS function does not; the plain-gradient path of the
    model uses `attention_jvp`, whose tangent map transposes instead.)"""
    return attention_jvp(q, k, v, causal=False)


@_attention_rcm.defjvp
def _attention_rcm_rule(primals, tangents):
    # fast=True: bf16 dot operands on the tensor cores; tangent error stays inside
    # the reference's own atol-1e-2 zero-mismatch envelope (BASELINE.md)
    return attention_value_and_jvp(*primals, *tangents, causal=False, fast=True)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    d_model: int = 256
    n_heads: int = 4
    head_dim: int = 64
    n_layers: int = 2
    mlp_ratio: int = 4
    seq_len: int = 256


def _init_linear(key, shape, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return jax.random.normal(key, shape, jnp.float32) * scale


def init_dit(key, cfg: DiTConfig):
    keys = jax.random.split(key, 3 + cfg.n_layers)
    params = {
        "t_mlp1": _init_linear(keys[0], (256, cfg.d_model)),
        "t_mlp2": _init_linear(keys[1], (cfg.d_model, cfg.d_model)),
        "out": _init_linear(keys[2], (cfg.d_model, cfg.d_model), scale=0.0),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        lk = jax.random.split(keys[3 + i], 7)
        params["layers"].append(
            {
                # adaLN: per-block (shift, scale, gate) x (attn, mlp)
                "ada": _init_linear(lk[0], (cfg.d_model, 6 * cfg.d_model), scale=0.0),
                "wq": _init_linear(lk[1], (cfg.d_model, cfg.n_heads * cfg.head_dim)),
                "wk": _init_linear(lk[2], (cfg.d_model, cfg.n_heads * cfg.head_dim)),
                "wv": _init_linear(lk[3], (cfg.d_model, cfg.n_heads * cfg.head_dim)),
                "wo": _init_linear(lk[4], (cfg.n_heads * cfg.head_dim, cfg.d_model)),
                "w1": _init_linear(lk[5], (cfg.d_model, cfg.d_model * cfg.mlp_ratio)),
                "w2": _init_linear(lk[6], (cfg.d_model * cfg.mlp_ratio, cfg.d_model)),
            }
        )
    return params


def _timestep_embed(t, dim=256):
    """Sinusoidal embedding of t [B] -> [B, dim]."""
    half = dim // 2
    freqs = jnp.exp(-math.log(10000.0) * jnp.arange(half, dtype=jnp.float32) / half)
    args = t[:, None].astype(jnp.float32) * freqs[None, :]
    return jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _ln(x, eps=1e-6):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps)


def dit_forward(params, x, t, cfg: DiTConfig, attention=None):
    """x [B, N, D] (patched latents), t [B] — returns the velocity field u.

    attention: (q, k, v, causal=) -> o. Defaults to `attention_jvp`
    (fwd-mode streams the tangent kernel; reverse mode transposes into the
    flash fp32 backward). `dit_jvp_step` swaps in the rCM pair rule.
    """
    attention = attention if attention is not None else (
        lambda q, k, v: attention_jvp(q, k, v, causal=False)
    )
    b, n, d = x.shape
    temb = jax.nn.silu(_timestep_embed(t) @ params["t_mlp1"]) @ params["t_mlp2"]

    for layer in params["layers"]:
        ada = jax.nn.silu(temb) @ layer["ada"]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = jnp.split(ada, 6, axis=-1)

        h = _modulate(_ln(x), sh_a, sc_a)
        q = (h @ layer["wq"]).reshape(b, n, cfg.n_heads, cfg.head_dim).transpose(0, 2, 1, 3)
        k = (h @ layer["wk"]).reshape(b, n, cfg.n_heads, cfg.head_dim).transpose(0, 2, 1, 3)
        v = (h @ layer["wv"]).reshape(b, n, cfg.n_heads, cfg.head_dim).transpose(0, 2, 1, 3)
        o = attention(q, k, v)
        o = o.transpose(0, 2, 1, 3).reshape(b, n, cfg.n_heads * cfg.head_dim)
        x = x + g_a[:, None, :] * (o @ layer["wo"])

        h = _modulate(_ln(x), sh_m, sc_m)
        x = x + g_m[:, None, :] * (jax.nn.gelu(h @ layer["w1"]) @ layer["w2"])

    return x @ params["out"] + x  # residual head


def dit_jvp_step(params, x_t, t, cfg: DiTConfig, dx_dt=None):
    """Compute (u, du/dt) along the probability-flow ODE in one fwd pass.

    The tangent direction is (dx/dt, dt/dt=1); if dx_dt is None the model's
    own velocity is used (the rCM self-consistency direction): first compute
    u = f(x, t), then push (u, 1) through as the tangent.

    Fully trainable: jax.grad of any loss over (u, du/dt) works — the
    attention jvp inside this trace is the (O, tO) pair kernel, backed by
    the second-order flash backward (ops/jvp_bwd); the dx_dt prepass uses
    the transpose-backed `attention_jvp`. This closes the rCM training loop
    the reference only gestures at (attention_jvp.py:1-11 — its kernel is
    forward-only).
    """
    if dx_dt is None:
        # stop-gradient the self-consistency direction, matching
        # make_dit_rcm_step's sharded path: rCM treats the tangent direction
        # as data, so single-device and sequence-parallel steps optimize the
        # SAME objective (gradients do not flow through the prepass)
        dx_dt = jax.lax.stop_gradient(dit_forward(params, x_t, t, cfg))
    return jax.jvp(
        lambda x_, t_: dit_forward(params, x_, t_, cfg, attention=_attention_rcm),
        (x_t, t),
        (dx_dt, jnp.ones_like(t)),
    )


# --------------------------------------------------------------------------
# Sequence-parallel rCM training: dp x sp over a (data, context) mesh with
# the JVP ring (parallel/ring.ring_attention_jvp). Everything except
# attention is per-token, so sequence sharding is free; the attention
# (O, tO) pair streams around the ring and its second-order backward rides
# the same ring. This is long-context consistency distillation — the
# reference's JVP kernel has neither a backward nor any distribution.
# --------------------------------------------------------------------------

def make_dit_rcm_step(mesh, cfg: DiTConfig, optimizer=None, fast: bool = True,
                      data_axis: str = "data", context_axis: str = "context"):
    """Returns (optimizer, step) with step: (params, opt_state, x, t) ->
    (params, opt_state, loss). x is a global [B, N, D] latent batch laid
    out P(data, context); t is [B] replicated. The rCM surrogate loss
    (mean du/dt^2 + 0.1 mean u^2) backpropagates through the JVP ring.
    """
    import functools

    import optax
    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu.parallel.ring import ring_attention, ring_attention_jvp

    if optimizer is None:
        optimizer = optax.adamw(1e-4)

    def _plain_ring(q, k, v):
        return ring_attention(q, k, v, context_axis, causal=False, kind="bf16")

    @jax.custom_jvp
    def _ring_rcm_attention(q, k, v):
        # primal-only path (feeds the stop-gradient tangent direction):
        # the plain bf16 ring — 3x fewer matmuls than the (O, tO) pair
        return _plain_ring(q, k, v)

    @_ring_rcm_attention.defjvp
    def _ring_rcm_rule(primals, tangents):
        return ring_attention_jvp(*primals, *tangents,
                                  axis_name=context_axis, fast=fast)

    x_spec = P(data_axis, context_axis, None)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), x_spec, P(data_axis)),
        out_specs=P(),
        check_vma=False,
    )
    def sharded_loss(params, x, t):
        def fwd(x_, t_):
            return dit_forward(params, x_, t_, cfg, attention=_ring_rcm_attention)

        # the prepass must NOT go through the pair-ruled custom_jvp (its rule
        # mixes primal and tangent args, which reverse-mode linearization
        # cannot split — same split as dit_jvp_step): plain bf16 ring, and
        # the direction is stop-gradiented per rCM anyway
        def fwd_plain(x_, t_):
            return dit_forward(params, x_, t_, cfg, attention=_plain_ring)

        dx_dt = jax.lax.stop_gradient(fwd_plain(x, t))  # rCM tangent direction
        u, dudt = jax.jvp(fwd, (x, t), (dx_dt, jnp.ones_like(t)))
        local = jnp.sum(dudt**2) + 0.1 * jnp.sum(u**2)
        total = jax.lax.psum(local, (data_axis, context_axis))
        count = jax.lax.psum(u.size, (data_axis, context_axis))
        loss = total / count
        # mesh axes this step does not use (e.g. 'model') replicate the whole
        # computation; a pmean over them is the identity on VALUES but makes
        # the shard_map transpose average — not sum — the replicated param
        # cotangents (without it, grads come out axis_size x too large)
        extra = tuple(a for a in mesh.axis_names
                      if a not in (data_axis, context_axis))
        if extra:
            loss = jax.lax.pmean(loss, extra)
        return loss

    @jax.jit
    def step(params, opt_state, x, t):
        loss, grads = jax.value_and_grad(sharded_loss)(params, x, t)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return optimizer, step
