"""Multi-chip training step: DP x TP x SP over a (data, model, context) mesh.

Megatron-style sharding expressed with shard_map + explicit collectives:
  * batch on `data` (pure DP, grads psum automatically via transpose);
  * attention heads and MLP hidden on `model` (TP) — attention itself is
    communication-free per head, the out/down projections psum partials;
  * sequence on `context` (SP) — ring attention rotates KV via ppermute,
    and RoPE positions / loss means account for the shard offset.

The whole loss is one shard_map; jax.value_and_grad differentiates through
it (ring attention carries its own custom_vjp ring backward). This is the
step dryrun_multichip compiles against N virtual devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from quantizedattention_tpu.models.transformer import TransformerConfig, rmsnorm, rope
from quantizedattention_tpu.parallel.ring import ring_attention
from quantizedattention_tpu.tune.config import BlockConfig


def param_specs(cfg: TransformerConfig):
    """PartitionSpec tree matching init_transformer's params.

    Head-sharded attention weights and hidden-sharded MLP weights on
    `model`; everything else replicated.
    """
    layer = {
        "ln1": P(),
        "wq": P(None, "model"),  # [D, H*hd] — heads on model
        "wk": P(None, "model"),
        "wv": P(None, "model"),
        "wo": P("model", None),  # [H*hd, D] — contraction sharded, psum after
        "ln2": P(),
        "w1": P(None, "model"),  # [D, F] — hidden on model
        "w2": P("model", None),
    }
    return {
        "embed": P(),
        "unembed": P(),
        "final_norm": P(),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


def _sharded_forward(params, tokens, cfg: TransformerConfig,
                     config: BlockConfig | None, attention: str = "bf16",
                     attention_sp: str = "ring"):
    """Per-device forward on local shards: tokens [B_loc, T_loc]."""
    from quantizedattention_tpu.parallel.collective import (
        allgather_kv_attention,
        allgather_kv_attention_int8,
    )
    from quantizedattention_tpu.parallel.ulysses import ulysses_attention
    from quantizedattention_tpu.parallel.zigzag import (
        zigzag_local_positions,
        zigzag_ring_attention,
        zigzag_ring_attention_int8,
    )
    n_model = jax.lax.axis_size("model")
    n_ctx = jax.lax.axis_size("context")
    ctx_idx = jax.lax.axis_index("context")
    b_loc, t_loc = tokens.shape
    h_loc = cfg.n_heads // n_model
    kv_loc = cfg.n_kv_heads // n_model
    if attention_sp == "zigzag":
        # local tokens are the zigzag (lo, hi) chunk pair — RoPE positions
        # follow the global permutation (the step permutes tokens/targets)
        positions = zigzag_local_positions(ctx_idx, n_ctx, t_loc)
    else:
        positions = ctx_idx * t_loc + jnp.arange(t_loc)

    x = params["embed"][tokens]
    for layer in params["layers"]:
        h = rmsnorm(x, layer["ln1"])
        q = (h @ layer["wq"]).reshape(b_loc, t_loc, h_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        k = (h @ layer["wk"]).reshape(b_loc, t_loc, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        v = (h @ layer["wv"]).reshape(b_loc, t_loc, kv_loc, cfg.head_dim).transpose(0, 2, 1, 3)
        q = rope(q, positions, cfg.rope_base)
        k = rope(k, positions, cfg.rope_base)
        # GQA: both SP strategies take UNREPEATED kv heads — only the
        # kv-group payload moves over the links; repeats happen locally
        if attention_sp == "ring":
            o = ring_attention(q, k, v, "context", causal=True, config=config,
                               kind=attention)
        elif attention_sp == "ulysses":
            o = ulysses_attention(q, k, v, "context", causal=True,
                                  config=config, kind=attention)
        elif attention_sp == "zigzag":
            zz = (zigzag_ring_attention_int8 if attention == "int8"
                  else zigzag_ring_attention)
            o = zz(q, k, v, "context", config=config)
        elif attention == "int8":
            o = allgather_kv_attention_int8(q, k, v, "context", causal=True,
                                            config=config)
        else:
            o = allgather_kv_attention(q, k, v, "context", causal=True,
                                       config=config)
        o = o.transpose(0, 2, 1, 3).reshape(b_loc, t_loc, h_loc * cfg.head_dim)
        # out-projection contracts the model-sharded head dim: psum partials
        attn_out = jax.lax.psum(o.astype(x.dtype) @ layer["wo"], "model")
        x = x + attn_out
        h = rmsnorm(x, layer["ln2"])
        mlp_out = jax.lax.psum(jax.nn.gelu(h @ layer["w1"]) @ layer["w2"], "model")
        x = x + mlp_out
    x = rmsnorm(x, params["final_norm"])
    return x @ params["unembed"]


def make_sharded_train_step(
    mesh: Mesh,
    cfg: TransformerConfig,
    optimizer=None,
    attention_config: BlockConfig | None = None,
    attention: str = "bf16",
    attention_sp: str = "auto",
):
    """Returns (optimizer, step) with step: (params, opt_state, tokens,
    targets) -> (params, opt_state, loss). tokens/targets are global
    [B, T] arrays laid out P('data', 'context').

    attention: "bf16" or "int8" — both differentiable under either SP
    strategy; "int8" moves quantized KV + scales over the links in forward AND
    backward. GQA (n_kv_heads < n_heads): unrepeated kv heads ride the
    collectives and feed the GQA-native kernels directly.

    attention_sp: "auto" (default — the analytic link-bytes/FLOPs model in
    parallel/scaling_model.py picks the predicted-faster strategy for this
    cfg + mesh, at the device's published peaks; a device with no row in
    the peak table raises), "ring" (contiguous shards, ppermute hops overlapped with
    compute), "zigzag" (striped shards — the causal ring without its
    last-rank load imbalance; the step permutes tokens/targets once),
    "ulysses" (all-to-all head<->seq; balanced causal work, needs heads
    divisible by the context axis), or "allgather" (K/V shards all-gather
    up front, dK/dV reduce-scatter home; best when per-hop latency
    dominates — short sequences / small shards).
    """
    import optax

    if optimizer is None:
        optimizer = optax.adamw(3e-4)
    if cfg.n_heads % mesh.shape["model"] != 0:
        raise ValueError("n_heads must divide the model axis")
    if cfg.n_kv_heads % mesh.shape["model"] != 0:
        raise ValueError("n_kv_heads must divide the model axis")
    if cfg.n_heads % cfg.n_kv_heads != 0:
        raise ValueError("n_heads must be a multiple of n_kv_heads")
    if attention not in ("bf16", "int8"):
        raise ValueError(f"unknown attention kind {attention!r}")
    if attention_sp not in ("auto", "ring", "allgather", "ulysses", "zigzag"):
        raise ValueError(f"unknown attention_sp {attention_sp!r}")
    n_ctx = int(mesh.shape["context"])
    n_model = int(mesh.shape["model"])
    h_loc = cfg.n_heads // n_model
    kv_loc = cfg.n_kv_heads // n_model
    if attention_sp == "ulysses" and (h_loc % n_ctx or kv_loc % n_ctx):
        raise ValueError(
            f"attention_sp='ulysses' needs per-shard head counts divisible "
            f"by the context axis ({h_loc}/{kv_loc} heads, context={n_ctx})"
        )
    was_auto = attention_sp == "auto"
    if attention_sp == "auto":
        from quantizedattention_tpu.parallel.scaling_model import best_sp_variant

        attention_sp = best_sp_variant(
            h=h_loc,
            h_kv=kv_loc,
            t_local=max(128, cfg.max_seq // max(1, n_ctx)),
            d=cfg.head_dim,
            n=n_ctx,
            kind=attention,
            allow_ulysses=(h_loc % n_ctx == 0 and kv_loc % n_ctx == 0),
            allow_zigzag=(cfg.max_seq % (2 * n_ctx) == 0
                          and (cfg.max_seq // (2 * n_ctx)) % 128 == 0),
        ) if n_ctx > 1 else "ring"

    specs = param_specs(cfg)
    tok_spec = P("data", "context")

    def _build_loss(sp):
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(specs, tok_spec, tok_spec),
            out_specs=P(),
            check_vma=False,
        )
        def sharded_loss(params, tokens, targets):
            logits = _sharded_forward(params, tokens, cfg, attention_config,
                                      attention, sp)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
            # global mean: sum over all shards / global token count
            total = jax.lax.psum(jnp.sum(nll), ("data", "context"))
            count = jax.lax.psum(nll.size, ("data", "context"))
            return total / count

        return sharded_loss

    primary_loss = _build_loss(attention_sp)
    # the strategy is chosen from cfg.max_seq, but some strategies carry a
    # RUNTIME shape constraint on the actual tokens: gate per step shape,
    # falling back to the (always-shardable) ring when "auto" made the pick
    fallback_loss = primary_loss if attention_sp == "ring" else None

    def _shape_ok(t: int) -> bool:
        if attention_sp == "zigzag":
            return t % (2 * n_ctx) == 0
        if attention_sp == "allgather" and attention == "int8":
            return t % n_ctx == 0 and (t // n_ctx) % 128 == 0
        return True

    @jax.jit
    def step(params, opt_state, tokens, targets):
        nonlocal fallback_loss
        sp, loss_fn = attention_sp, primary_loss
        if not _shape_ok(tokens.shape[1]):
            if not was_auto:
                raise ValueError(
                    f"attention_sp={attention_sp!r} cannot shard sequence "
                    f"length {tokens.shape[1]} over context={n_ctx} "
                    f"(zigzag needs t % {2 * n_ctx} == 0; int8 all-gather "
                    f"needs 128-multiple shards) — pick a compatible length "
                    f"or another strategy"
                )
            if fallback_loss is None:
                fallback_loss = _build_loss("ring")
            sp, loss_fn = "ring", fallback_loss
        if sp == "zigzag":
            # re-order the GLOBAL sequence so contiguous context shards hold
            # zigzag (lo, hi) chunk pairs; the per-token mean loss is
            # permutation-invariant (targets move with their tokens)
            from quantizedattention_tpu.parallel.zigzag import zigzag_perm

            zp = zigzag_perm(n_ctx, tokens.shape[1])
            tokens = tokens[:, zp]
            targets = targets[:, zp]
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens, targets)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return optimizer, step
