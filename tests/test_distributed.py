"""Distribution layer tests on an 8-device emulated CPU mesh.

The reference has no distributed path at all (SURVEY.md §2.4); these tests
pin the new capability: sharded results must match the single-device oracle
bit-for-bit in structure and within kernel tolerance in value.
"""

import jax
import jax.numpy as jnp
import pytest

from quantizedattention_tpu.parallel import (
    make_attention_mesh,
    make_ring_attention,
    make_sharded_attention,
)
from quantizedattention_tpu.reference import reference_attention
from quantizedattention_tpu.utils.testing import mismatch_report
from tests.conftest import make_qkv

# the whole module builds >=8-way meshes (conftest emulates 8 CPU devices)
pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (emulated) devices"
)


def test_mesh_construction():
    mesh = make_attention_mesh(data=2, model=2, context=2)
    assert mesh.shape == {"data": 2, "model": 2, "context": 2}


@pytest.mark.parametrize("kind,atol", [("bf16", 1e-2), ("int8", 5e-2)])
def test_head_tp_data_parallel(rng, kind, atol):
    """batch on 2-way data, heads on 4-way model — communication-free."""
    mesh = make_attention_mesh(data=2, model=4)
    q, k, v, _ = make_qkv(rng, batch=2, head=4, q_tokens=256)
    fn = make_sharded_attention(mesh, kind=kind, causal=True)
    o = fn(q, k, v)
    want = reference_attention(q, k, v, causal=True)
    rep = mismatch_report(f"tp {kind}", o, want, atol=atol)
    assert rep.mismatch_rate <= 2e-3, rep


def test_head_tp_differentiable(rng):
    """Gradients flow through the shard_map + custom_vjp composition."""
    mesh = make_attention_mesh(data=1, model=2)
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=256)
    fn = make_sharded_attention(mesh, kind="bf16", causal=False)

    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    from quantizedattention_tpu.reference import reference_attention_vjp

    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep = mismatch_report(nm, g, w, atol=1e-2)
        assert rep.mismatch_rate <= 3.5e-4, rep


@pytest.mark.parametrize("kind,causal,atol", [
    ("bf16", False, 1e-2),
    ("bf16", True, 1e-2),
    ("int8", False, 5e-2),
    ("int8", True, 5e-2),
])
def test_ring_attention(rng, kind, causal, atol):
    """4-way sequence-sharded ring == unsharded oracle."""
    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=512)
    fn = make_ring_attention(mesh, kind=kind, causal=causal)
    o = fn(q, k, v)
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report(f"ring {kind} causal={causal}", o, want, atol=atol)
    assert rep.mismatch_rate <= 2e-3, rep
    assert not bool(jnp.any(jnp.isnan(o)))


def test_ring_matches_single_device_kernel(rng):
    """The ring must agree with the *same kernel* run unsharded — isolating
    communication/merge errors from kernel quantization error."""
    from quantizedattention_tpu.ops.flash_fwd import flash_attention_fwd

    mesh = make_attention_mesh(data=1, model=1, context=4)
    q, k, v, _ = make_qkv(rng, batch=1, head=1, q_tokens=512)
    fn = make_ring_attention(mesh, kind="bf16", causal=False)
    o_ring = fn(q, k, v)
    o_single, _ = flash_attention_fwd(q, k, v, causal=False)
    rep = mismatch_report("ring vs single", o_ring, o_single, atol=1e-3)
    assert rep.mismatch_rate <= 1e-4, rep


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_differentiable(rng, causal):
    """The ring backward (rotating dK/dV accumulators) == oracle gradients."""
    from quantizedattention_tpu.reference import reference_attention_vjp

    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=512)
    fn = make_ring_attention(mesh, kind="bf16", causal=causal)

    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=causal)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep = mismatch_report(f"ring {nm}", g, w, atol=1e-2)
        assert rep.mismatch_rate <= 3.5e-4, rep


@pytest.mark.parametrize("causal", [False, True])
def test_int8_ring_attention_differentiable(rng, causal):
    """int8 ring backward (rotating int8 payloads + scales) vs oracle.

    Gradients carry int8 quantization error, so the bar is the same
    mismatch-rate envelope as the single-device int8 backward tests.
    """
    from quantizedattention_tpu.reference import reference_attention_vjp

    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=512)
    fn = make_ring_attention(mesh, kind="int8", causal=causal)

    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=causal)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep = mismatch_report(f"int8 ring {nm}", g, w, atol=5e-2)
        assert rep.mismatch_rate <= 2e-3, rep
        assert not bool(jnp.any(jnp.isnan(g)))


@pytest.mark.parametrize("kind,atol", [("bf16", 1e-2), ("int8", 5e-2)])
def test_gqa_ring_attention_differentiable(rng, kind, atol):
    """GQA rings rotate UNREPEATED kv heads (code-review finding: repeating
    before the ring inflated ICI payload rep-x); forward and gradients must
    match the oracle on repeated heads, with dk/dv group-summed."""
    from quantizedattention_tpu.reference import reference_attention

    mesh = make_attention_mesh(data=1, model=1, context=4)
    q, _, _, do = make_qkv(rng, batch=1, head=4, q_tokens=512)
    kk, kv_ = jax.random.split(jax.random.key(21))
    k = jax.random.normal(kk, (1, 2, 512, 64))   # 2 kv heads, rep=2
    v = jax.random.normal(kv_, (1, 2, 512, 64))
    fn = make_ring_attention(mesh, kind=kind, causal=True)

    o = fn(q, k, v)
    k_rep, v_rep = jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1)
    want = reference_attention(q, k_rep, v_rep, causal=True)
    rep_o = mismatch_report(f"gqa ring {kind} fwd", o, want, atol=atol)
    assert rep_o.mismatch_rate <= 2e-3, rep_o

    dq, dk, dv = jax.grad(
        lambda *a: jnp.sum(fn(*a) * do), argnums=(0, 1, 2)
    )(q, k, v)
    assert dk.shape == k.shape and dv.shape == v.shape

    def loss_ref(q_, k_, v_):
        return jnp.sum(reference_attention(
            q_, jnp.repeat(k_, 2, axis=1), jnp.repeat(v_, 2, axis=1),
            causal=True) * do)

    dq_w, dk_w, dv_w = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep_g = mismatch_report(f"gqa ring {kind} {nm}", g, w, atol=5 * atol)
        assert rep_g.mismatch_rate <= 2e-3, rep_g


def test_int8_ring_matches_single_device_int8_grads(rng):
    """int8 ring grads == the single-device int8 custom_vjp grads — isolates
    ring communication errors from quantization error. Not bit-exact: the
    ring quantizes K/V per shard (finer grain) while single-device uses one
    table, so compare within a tight envelope."""
    from quantizedattention_tpu import sage_attention_int8

    mesh = make_attention_mesh(data=1, model=1, context=4)
    q, k, v, do = make_qkv(rng, batch=1, head=1, q_tokens=512)
    fn = make_ring_attention(mesh, kind="int8", causal=False)

    g_ring = jax.grad(lambda *a: jnp.sum(fn(*a) * do), argnums=(0, 1, 2))(q, k, v)
    g_single = jax.grad(
        lambda *a: jnp.sum(sage_attention_int8(*a, causal=False) * do),
        argnums=(0, 1, 2),
    )(q, k, v)
    for nm, g, w in zip(("dq", "dk", "dv"), g_ring, g_single):
        rep = mismatch_report(f"int8 ring-vs-single {nm}", g, w, atol=2e-2)
        assert rep.mismatch_rate <= 2e-3, rep


@pytest.mark.parametrize("kind,causal,atol", [
    ("bf16", True, 1e-2),
    ("int8", False, 5e-2),
])
def test_ulysses_attention(rng, kind, causal, atol):
    """All-to-all head<->seq swap == unsharded oracle (heads % devices == 0)."""
    from quantizedattention_tpu.parallel import make_ulysses_attention

    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, _ = make_qkv(rng, batch=1, head=8, q_tokens=512)
    fn = make_ulysses_attention(mesh, kind=kind, causal=causal)
    o = fn(q, k, v)
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report(f"ulysses {kind}", o, want, atol=atol)
    assert rep.mismatch_rate <= 2e-3, rep


def test_ulysses_indivisible_kv_heads_raises(rng):
    """GQA kv heads not divisible by the context axis cannot ride the
    head<->seq all-to-all; the guard must say so instead of mis-sharding."""
    from quantizedattention_tpu.parallel import make_ulysses_attention

    mesh = make_attention_mesh(data=1, model=1, context=4)
    q, _, _, _ = make_qkv(rng, batch=1, head=8, q_tokens=512)
    _, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=512)
    fn = make_ulysses_attention(mesh, kind="bf16", causal=True)
    with pytest.raises(ValueError, match="divisible by the axis size"):
        fn(q, k, v)


def test_ulysses_differentiable(rng):
    from quantizedattention_tpu.parallel import make_ulysses_attention
    from quantizedattention_tpu.reference import reference_attention_vjp

    mesh = make_attention_mesh(data=1, model=1, context=4)
    q, k, v, do = make_qkv(rng, batch=1, head=4, q_tokens=512)
    fn = make_ulysses_attention(mesh, kind="bf16", causal=True)
    dq, dk, dv = jax.grad(
        lambda a, b, c: jnp.sum(fn(a, b, c) * do), argnums=(0, 1, 2)
    )(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=True)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep = mismatch_report(f"ulysses {nm}", g, w, atol=1e-2)
        assert rep.mismatch_rate <= 3.5e-4, rep


@pytest.mark.parametrize("causal", [False, True])
def test_allgather_kv_attention(rng, causal):
    """all-gather-KV sequence parallelism == unsharded oracle."""
    from quantizedattention_tpu.parallel import make_allgather_attention

    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=512)
    fn = make_allgather_attention(mesh, causal=causal)
    o = fn(q, k, v)
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report(f"allgather causal={causal}", o, want, atol=1e-2)
    assert rep.mismatch_rate <= 2e-3, rep


@pytest.mark.parametrize("causal", [False, True])
def test_allgather_kv_attention_differentiable(rng, causal):
    """dK/dV reduce-scatter backward == oracle gradients."""
    from quantizedattention_tpu.parallel import make_allgather_attention
    from quantizedattention_tpu.reference import reference_attention_vjp

    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=512)
    fn = make_allgather_attention(mesh, causal=causal)

    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=causal)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep = mismatch_report(f"allgather {nm}", g, w, atol=1e-2)
        assert rep.mismatch_rate <= 3.5e-4, rep


@pytest.mark.parametrize("causal", [False, True])
def test_allgather_int8_attention_and_grads(rng, causal):
    """int8 all-gather SP: quantized payload + scales gather (~1/4 the ICI
    bytes) and the backward reduce-scatters dK/dV; fwd and grads vs oracle
    within the int8 envelope. Causal rides the int8 kernels' global q/k
    offsets."""
    from quantizedattention_tpu.parallel import make_allgather_attention
    from quantizedattention_tpu.reference import reference_attention_vjp

    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=512)
    fn = make_allgather_attention(mesh, causal=causal, kind="int8")

    o = fn(q, k, v)
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report(f"ag int8 fwd causal={causal}", o, want, atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep

    dq, dk, dv = jax.grad(
        lambda *a: jnp.sum(fn(*a) * do), argnums=(0, 1, 2)
    )(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=causal)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep_g = mismatch_report(f"ag int8 {nm}", g, w, atol=5e-2)
        assert rep_g.mismatch_rate <= 2e-3, rep_g


@pytest.mark.parametrize("causal", [False, True])
def test_kv_sharded_attention_int8(rng, causal):
    """Replicated-Q / int8-sharded-KV partial merge == unsharded oracle
    (per-shard quantization + global k_offset causal masking)."""
    import functools

    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu.parallel import kv_sharded_attention_int8

    mesh = make_attention_mesh(data=1, model=1, context=4)
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=256)
    kv_spec = P(None, None, "context", None)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), kv_spec, kv_spec), out_specs=P(),
        check_vma=False,
    )
    def fn(q_, k_, v_):
        return kv_sharded_attention_int8(q_, k_, v_, "context", causal=causal)

    o = fn(q, k, v)
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report(f"kv-sharded int8 causal={causal}", o, want, atol=5e-2)
    assert rep.mismatch_rate <= 2e-3, rep


@pytest.mark.parametrize("causal", [False, True])
def test_kv_sharded_attention(rng, causal):
    """Replicated-Q / sharded-KV partial merge == unsharded oracle."""
    import functools

    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu.parallel import kv_sharded_attention

    mesh = make_attention_mesh(data=1, model=1, context=4)
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=256)
    kv_spec = P(None, None, "context", None)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), kv_spec, kv_spec), out_specs=P(),
        check_vma=False,
    )
    def fn(q_, k_, v_):
        return kv_sharded_attention(q_, k_, v_, "context", causal=causal)

    o = fn(q, k, v)
    want = reference_attention(q, k, v, causal=causal)
    rep = mismatch_report(f"kv-sharded causal={causal}", o, want, atol=1e-2)
    assert rep.mismatch_rate <= 2e-3, rep


@pytest.mark.parametrize("causal", [False, True])
def test_jvp_ring_forward_and_grads(rng, causal):
    """Sequence-parallel (O, tO) ring: the four-way (o, to, lse, mu) merge
    must equal the unsharded oracle pair, and the second-order ring backward
    must match jax.grad-of-jax.jvp of the fp32 oracle — the long-context
    rCM training path (no reference counterpart at any scale)."""
    import functools

    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu.parallel import ring_attention_jvp
    from quantizedattention_tpu.reference import reference_attention

    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, _ = make_qkv(rng, batch=1, head=2, q_tokens=512)
    tq, tk, tv = (jax.random.normal(kk_, q.shape)
                  for kk_ in jax.random.split(jax.random.key(17), 3))
    wo = jax.random.normal(jax.random.key(18), q.shape)
    wt = jax.random.normal(jax.random.key(19), q.shape)
    spec = P(None, "model", "context", None)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec,) * 6, out_specs=(spec, spec),
        check_vma=False,
    )
    def pair(*args):
        return ring_attention_jvp(*args, axis_name="context", causal=causal)

    o, to = pair(q, k, v, tq, tk, tv)
    o_w, to_w = jax.jvp(
        lambda a, b, c: reference_attention(a, b, c, causal=causal),
        (q, k, v), (tq, tk, tv),
    )
    assert mismatch_report("jvp ring O", o, o_w, atol=1e-2).mismatches == 0
    assert mismatch_report("jvp ring tO", to, to_w, atol=1e-2).mismatches == 0

    def loss(*args):
        o_, to_ = pair(*args)
        return jnp.sum(o_ * wo) + jnp.sum(to_ * wt)

    def loss_ref(q_, k_, v_, tq_, tk_, tv_):
        o_, to_ = jax.jvp(
            lambda a, b, c: reference_attention(a, b, c, causal=causal),
            (q_, k_, v_), (tq_, tk_, tv_),
        )
        return jnp.sum(o_ * wo) + jnp.sum(to_ * wt)

    got = jax.grad(loss, argnums=tuple(range(6)))(q, k, v, tq, tk, tv)
    want = jax.grad(loss_ref, argnums=tuple(range(6)))(q, k, v, tq, tk, tv)
    for g, w, n in zip(got, want, ["q", "k", "v", "tq", "tk", "tv"]):
        rep = mismatch_report(f"jvp ring d{n}", g, w, atol=1e-2)
        assert rep.mismatch_rate <= 3.5e-4, rep


def test_jvp_pair_under_head_tp(rng):
    """The (O, tO) pair kernel + its second-order backward compose with
    head-TP shard_map (attention is per-head, so the tangent map and the
    jvp backward shard trivially on the model axis)."""
    import functools

    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu import attention_value_and_jvp
    from quantizedattention_tpu.reference import reference_attention

    mesh = make_attention_mesh(data=1, model=4, context=1)
    q, k, v, _ = make_qkv(rng, batch=1, head=4, q_tokens=256)
    tq, tk, tv = (jax.random.normal(kk_, q.shape)
                  for kk_ in jax.random.split(jax.random.key(13), 3))
    w = jax.random.normal(jax.random.key(14), q.shape)
    spec = P(None, "model", None, None)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec,) * 7, out_specs=(spec,) * 3,
        check_vma=False,
    )
    def grads(q_, k_, v_, tq_, tk_, tv_, w_):
        def loss(a, b, c):
            o, to = attention_value_and_jvp(a, b, c, tq_, tk_, tv_)
            return jnp.sum(to * w_) + jnp.sum(o)
        return jax.grad(loss, argnums=(0, 1, 2))(q_, k_, v_)

    got = grads(q, k, v, tq, tk, tv, w)

    def loss_ref(a, b, c):
        o, to = jax.jvp(reference_attention, (a, b, c), (tq, tk, tv))
        return jnp.sum(to * w) + jnp.sum(o)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for g, wnt, n in zip(got, want, "qkv"):
        rep = mismatch_report(f"tp jvp d{n}", g, wnt, atol=1e-2)
        assert rep.mismatch_rate <= 3.5e-4, rep


def test_pod_mesh_single_slice_equivalence(rng):
    """make_pod_mesh degrades to the single-slice mesh on one process, and
    the sharded attention built on it matches the oracle."""
    from quantizedattention_tpu.parallel import make_pod_mesh

    mesh = make_pod_mesh(data_dcn=1, data=2, model=2, context=2)
    assert mesh.shape == {"data": 2, "model": 2, "context": 2}
    q, k, v, _ = make_qkv(rng, batch=2, head=2, q_tokens=256)
    fn = make_ring_attention(mesh, kind="bf16", causal=True)
    rep = mismatch_report("pod-mesh ring", fn(q, k, v),
                          reference_attention(q, k, v, causal=True), atol=1e-2)
    assert rep.mismatch_rate <= 2e-3, rep


def test_pod_mesh_validates_device_count():
    from quantizedattention_tpu.parallel import make_pod_mesh

    with pytest.raises(ValueError, match="devices"):
        make_pod_mesh(data_dcn=3, data=5, model=1, context=1)


def test_pod_mesh_dcn_train_step(rng, h100_rates):
    """DCN-replicated pod mesh (data_dcn=2 x 2x2 ICI, emulated): the hybrid
    mesh builds, the dp x tp x sp train step compiles+runs on it, and its
    loss matches the single-device LM loss (round-1 verdict missing #6 —
    the data_dcn>1 path had zero coverage)."""
    from quantizedattention_tpu.models import (
        TransformerConfig, init_transformer, lm_loss, make_sharded_train_step,
    )
    from quantizedattention_tpu.parallel import make_pod_mesh

    mesh = make_pod_mesh(data_dcn=2, data=1, model=2, context=2)
    assert mesh.shape == {"data": 2, "model": 2, "context": 2}

    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2,
                            head_dim=64, n_layers=1, max_seq=256)
    params = init_transformer(rng, cfg)
    tokens = jax.random.randint(jax.random.key(7), (4, 256), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)
    optimizer, step = make_sharded_train_step(mesh, cfg)
    _, _, loss = step(params, optimizer.init(params), tokens, targets)
    want = lm_loss(params, tokens, targets, cfg)
    assert abs(float(loss) - float(want)) < 2e-2


@pytest.mark.parametrize("attention", ["bf16", "int8"])
def test_train_step_attention_sp_allgather_parity(rng, attention):
    """attention_sp='allgather' optimizes the same objective as the default
    ring: one step from identical params yields the same loss and params
    within kernel tolerance (round-2 verdict weak #6 / next #8 — the
    all-gather SP path existed only as a library function)."""
    from quantizedattention_tpu.models import (
        TransformerConfig, init_transformer, make_sharded_train_step,
    )

    mesh = make_attention_mesh(data=2, model=2, context=2)
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2,
                            head_dim=64, n_layers=1, max_seq=256)
    params = init_transformer(rng, cfg)
    tokens = jax.random.randint(jax.random.key(3), (4, 256), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)

    optimizer, step_ring = make_sharded_train_step(
        mesh, cfg, attention=attention, attention_sp="ring"
    )
    _, step_ag = make_sharded_train_step(
        mesh, cfg, attention=attention, attention_sp="allgather"
    )
    opt0 = optimizer.init(params)
    p_ring, _, loss_ring = step_ring(params, opt0, tokens, targets)
    p_ag, _, loss_ag = step_ag(params, opt0, tokens, targets)
    tol = 2e-3 if attention == "bf16" else 1e-2
    assert abs(float(loss_ring) - float(loss_ag)) < tol
    for a, b in zip(jax.tree_util.tree_leaves(p_ring),
                    jax.tree_util.tree_leaves(p_ag)):
        assert jnp.max(jnp.abs(a - b)) < 5e-2


def test_train_step_gqa_allgather_parity(rng):
    """GQA (kv groups) through the all-gather SP path: the unrepeated-head
    gather + local repeat and the group-summed dK/dV reduce-scatter match
    the ring step."""
    from quantizedattention_tpu.models import (
        TransformerConfig, init_transformer, make_sharded_train_step,
    )

    mesh = make_attention_mesh(data=1, model=2, context=4)
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2,
                            head_dim=32, n_layers=1, max_seq=512)
    params = init_transformer(rng, cfg)
    tokens = jax.random.randint(jax.random.key(5), (2, 512), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)

    optimizer, step_ring = make_sharded_train_step(mesh, cfg, attention_sp="ring")
    _, step_ag = make_sharded_train_step(mesh, cfg, attention_sp="allgather")
    opt0 = optimizer.init(params)
    p_ring, _, loss_ring = step_ring(params, opt0, tokens, targets)
    p_ag, _, loss_ag = step_ag(params, opt0, tokens, targets)
    assert abs(float(loss_ring) - float(loss_ag)) < 2e-3
    for a, b in zip(jax.tree_util.tree_leaves(p_ring),
                    jax.tree_util.tree_leaves(p_ag)):
        assert jnp.max(jnp.abs(a - b)) < 5e-2


def test_initialize_multihost_single_process():
    """Auto-detect path: no cluster env -> clean single-process no-op (and
    idempotent on repeat calls)."""
    from quantizedattention_tpu.parallel import initialize_multihost

    initialize_multihost()
    initialize_multihost()
    assert len(jax.devices()) >= 1


def test_train_step_attention_sp_ulysses_parity(rng):
    """attention_sp='ulysses' (all-to-all head<->seq re-shard, GQA payload
    unrepeated on the wire) optimizes the same objective as the ring — the
    analytic model (parallel/scaling_model.py) predicts it as the best
    causal strategy when heads divide, so its train-step path needs the
    same parity pinning."""
    from quantizedattention_tpu.models import (
        TransformerConfig, init_transformer, make_sharded_train_step,
    )

    mesh = make_attention_mesh(data=2, model=1, context=2)
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2,
                            head_dim=32, n_layers=1, max_seq=256)
    params = init_transformer(rng, cfg)
    tokens = jax.random.randint(jax.random.key(9), (4, 256), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)

    optimizer, step_ring = make_sharded_train_step(mesh, cfg, attention_sp="ring")
    _, step_uly = make_sharded_train_step(mesh, cfg, attention_sp="ulysses")
    opt0 = optimizer.init(params)
    p_ring, _, loss_ring = step_ring(params, opt0, tokens, targets)
    p_uly, _, loss_uly = step_uly(params, opt0, tokens, targets)
    assert abs(float(loss_ring) - float(loss_uly)) < 2e-3
    for a, b in zip(jax.tree_util.tree_leaves(p_ring),
                    jax.tree_util.tree_leaves(p_uly)):
        assert jnp.max(jnp.abs(a - b)) < 5e-2


def test_train_step_attention_sp_auto_resolves(rng, request):
    """attention_sp='auto' (the default) resolves via the analytic model and
    produces a working step (at the H100's rates: the CPU has no row in the
    peak table, and auto raises there); 'ulysses' with indivisible heads
    raises."""
    from quantizedattention_tpu.models import (
        TransformerConfig, init_transformer, make_sharded_train_step,
    )

    mesh = make_attention_mesh(data=2, model=1, context=2)
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=4,
                            head_dim=32, n_layers=1, max_seq=256)
    params = init_transformer(rng, cfg)
    tokens = jax.random.randint(jax.random.key(11), (4, 256), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)
    with pytest.raises(KeyError, match="no published peaks"):
        make_sharded_train_step(mesh, cfg)  # auto, no rates for the CPU
    request.getfixturevalue("h100_rates")
    optimizer, step = make_sharded_train_step(mesh, cfg)
    _, _, loss = step(params, optimizer.init(params), tokens, targets)
    assert jnp.isfinite(loss)

    bad = TransformerConfig(vocab_size=64, d_model=96, n_heads=3, n_kv_heads=3,
                            head_dim=32, n_layers=1, max_seq=256)
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_train_step(mesh, bad, attention_sp="ulysses")


@pytest.mark.parametrize("gqa", [False, True])
def test_zigzag_ring_attention_parity(rng, gqa):
    """Zigzag (striped) causal ring == oracle on the permuted sequence —
    forward AND gradients (the dK/dV accumulators ride the ring home).
    The zigzag removes the contiguous ring's last-rank causal imbalance
    (parallel/scaling_model.py); no reference counterpart."""
    import functools

    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu.parallel.zigzag import (
        zigzag_perm, zigzag_ring_attention,
    )
    from quantizedattention_tpu.reference import reference_attention_vjp

    mesh = make_attention_mesh(data=1, model=2, context=4)
    t = 512
    q, _, _, do = make_qkv(rng, batch=1, head=2, q_tokens=t)
    n_kv = 1 if gqa else 2
    kk, kv_ = jax.random.split(jax.random.key(33))
    k = jax.random.normal(kk, (1, n_kv, t, 64))
    v = jax.random.normal(kv_, (1, n_kv, t, 64))
    perm = zigzag_perm(4, t)

    spec = P(None, "model", None if gqa else "model", None)
    qspec = P(None, "model", "context", None)
    # kv heads replicate over model when GQA (1 head), else shard
    kvspec = P(None, None if gqa else "model", "context", None)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(qspec, kvspec, kvspec), out_specs=qspec, check_vma=False,
    )
    def zz(q_, k_, v_):
        return zigzag_ring_attention(q_, k_, v_, "context")

    qp, kp, vp = q[:, :, perm], k[:, :, perm], v[:, :, perm]
    o_p = zz(qp, kp, vp)
    k_rep = jnp.repeat(k, 2, axis=1) if gqa else k
    v_rep = jnp.repeat(v, 2, axis=1) if gqa else v
    want = reference_attention(q, k_rep, v_rep, causal=True)[:, :, perm]
    rep_o = mismatch_report(f"zigzag gqa={gqa}", o_p, want, atol=1e-2)
    assert rep_o.mismatch_rate <= 2e-3, rep_o

    def loss(q_, k_, v_):
        return jnp.sum(zz(q_, k_, v_) * do[:, :, perm])

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(qp, kp, vp)
    assert dk.shape == kp.shape

    def loss_ref(q_, k_, v_):
        kr = jnp.repeat(k_, 2, axis=1) if gqa else k_
        vr = jnp.repeat(v_, 2, axis=1) if gqa else v_
        return jnp.sum(reference_attention(q_, kr, vr, causal=True) * do)

    dq_w, dk_w, dv_w = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for nm, g, w in [("dq", dq, dq_w[:, :, perm]), ("dk", dk, dk_w[:, :, perm]),
                     ("dv", dv, dv_w[:, :, perm])]:
        rep_g = mismatch_report(f"zigzag {nm}", g, w, atol=2e-2)
        assert rep_g.mismatch_rate <= 2e-3, rep_g


def test_train_step_attention_sp_zigzag_parity(rng):
    """attention_sp='zigzag' (striped causal ring + in-step permutation +
    zigzag RoPE positions) optimizes the same objective as the ring."""
    from quantizedattention_tpu.models import (
        TransformerConfig, init_transformer, make_sharded_train_step,
    )

    mesh = make_attention_mesh(data=1, model=2, context=4)
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2,
                            head_dim=64, n_layers=1, max_seq=1024)
    params = init_transformer(rng, cfg)
    tokens = jax.random.randint(jax.random.key(13), (2, 1024), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)

    optimizer, step_ring = make_sharded_train_step(mesh, cfg, attention_sp="ring")
    _, step_zz = make_sharded_train_step(mesh, cfg, attention_sp="zigzag")
    opt0 = optimizer.init(params)
    p_ring, _, loss_ring = step_ring(params, opt0, tokens, targets)
    p_zz, _, loss_zz = step_zz(params, opt0, tokens, targets)
    assert abs(float(loss_ring) - float(loss_zz)) < 2e-3
    for a, b in zip(jax.tree_util.tree_leaves(p_ring),
                    jax.tree_util.tree_leaves(p_zz)):
        assert jnp.max(jnp.abs(a - b)) < 5e-2


def test_int8_zigzag_ring_parity(rng):
    """int8 zigzag: quantized chunk pairs + scales rotate; fwd and grads
    match the oracle within the int8 envelope."""
    import functools

    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu.parallel.zigzag import (
        zigzag_perm, zigzag_ring_attention_int8,
    )
    from quantizedattention_tpu.reference import reference_attention_vjp

    mesh = make_attention_mesh(data=1, model=2, context=4)
    t = 1024
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=t)
    perm = zigzag_perm(4, t)
    spec = P(None, "model", "context", None)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(spec,) * 3, out_specs=spec, check_vma=False,
    )
    def zz(q_, k_, v_):
        return zigzag_ring_attention_int8(q_, k_, v_, "context")

    qp, kp, vp = q[:, :, perm], k[:, :, perm], v[:, :, perm]
    o_p = zz(qp, kp, vp)
    want = reference_attention(q, k, v, causal=True)[:, :, perm]
    rep_o = mismatch_report("int8 zigzag fwd", o_p, want, atol=5e-2)
    assert rep_o.mismatch_rate <= 2e-3, rep_o

    def loss(q_, k_, v_):
        return jnp.sum(zz(q_, k_, v_) * do[:, :, perm])

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(qp, kp, vp)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=True)
    for nm, g, w in [("dq", dq, dq_w[:, :, perm]), ("dk", dk, dk_w[:, :, perm]),
                     ("dv", dv, dv_w[:, :, perm])]:
        rel = float(jnp.linalg.norm(g - w)
                    / jnp.maximum(jnp.linalg.norm(w), 1e-6))
        assert rel <= 0.06, (nm, rel)
        assert not bool(jnp.any(jnp.isnan(g))), nm


def test_train_step_int8_zigzag(rng):
    """attention='int8' + attention_sp='zigzag' trains and matches the int8
    ring step's objective."""
    from quantizedattention_tpu.models import (
        TransformerConfig, init_transformer, make_sharded_train_step,
    )

    mesh = make_attention_mesh(data=1, model=2, context=4)
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2,
                            head_dim=64, n_layers=1, max_seq=1024)
    params = init_transformer(rng, cfg)
    tokens = jax.random.randint(jax.random.key(17), (2, 1024), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)

    optimizer, step_ring = make_sharded_train_step(
        mesh, cfg, attention="int8", attention_sp="ring")
    _, step_zz = make_sharded_train_step(
        mesh, cfg, attention="int8", attention_sp="zigzag")
    opt0 = optimizer.init(params)
    _, _, loss_ring = step_ring(params, opt0, tokens, targets)
    _, _, loss_zz = step_zz(params, opt0, tokens, targets)
    assert abs(float(loss_ring) - float(loss_zz)) < 1e-2


def test_gqa_int8_allgather_attention(rng):
    """GQA through the int8 all-gather: the UNREPEATED quantized payload +
    scales ride the wire (1/rep the bytes), repeats happen after the
    gather, and dK/dV group-sum before the reduce-scatter."""
    import functools

    from jax.sharding import PartitionSpec as P

    from quantizedattention_tpu.parallel.collective import (
        allgather_kv_attention_int8,
    )

    mesh = make_attention_mesh(data=1, model=1, context=4)
    t = 512
    q, _, _, do = make_qkv(rng, batch=1, head=4, q_tokens=t)
    kk, kv_ = jax.random.split(jax.random.key(41))
    k = jax.random.normal(kk, (1, 2, t, 64))
    v = jax.random.normal(kv_, (1, 2, t, 64))
    qspec = P(None, None, "context", None)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(qspec,) * 3, out_specs=qspec, check_vma=False,
    )
    def ag(q_, k_, v_):
        return allgather_kv_attention_int8(q_, k_, v_, "context", causal=True)

    o = ag(q, k, v)
    k_r, v_r = jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1)
    want = reference_attention(q, k_r, v_r, causal=True)
    rep_o = mismatch_report("gqa int8 ag fwd", o, want, atol=5e-2)
    assert rep_o.mismatch_rate <= 2e-3, rep_o

    def loss(q_, k_, v_):
        return jnp.sum(ag(q_, k_, v_) * do)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    assert dk.shape == k.shape

    def loss_ref(q_, k_, v_):
        return jnp.sum(reference_attention(
            q_, jnp.repeat(k_, 2, axis=1), jnp.repeat(v_, 2, axis=1),
            causal=True) * do)

    dq_w, dk_w, dv_w = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rel = float(jnp.linalg.norm(g - w)
                    / jnp.maximum(jnp.linalg.norm(w), 1e-6))
        assert rel <= 0.06, (nm, rel)


def test_attention_sp_runtime_shape_gate(rng, h100_rates):
    """The strategy is picked from cfg.max_seq but gated on the ACTUAL
    sequence length at step time: auto falls back to the ring for
    zigzag-incompatible lengths; an EXPLICIT zigzag raises a clear error."""
    from quantizedattention_tpu.models import (
        TransformerConfig, init_transformer, lm_loss, make_sharded_train_step,
    )

    mesh = make_attention_mesh(data=1, model=1, context=4)
    cfg = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_kv_heads=2,
                            head_dim=64, n_layers=1, max_seq=1024)
    params = init_transformer(rng, cfg)
    # 516 divides the 4-way context axis but NOT 2n=8 — zigzag-impossible
    tokens = jax.random.randint(jax.random.key(23), (2, 516), 0, cfg.vocab_size)
    targets = jnp.roll(tokens, -1, axis=1)

    optimizer, step = make_sharded_train_step(mesh, cfg)  # auto
    _, _, loss = step(params, optimizer.init(params), tokens, targets)
    want = lm_loss(params, tokens, targets, cfg)
    assert abs(float(loss) - float(want)) < 2e-2  # ring fallback ran

    _, step_zz = make_sharded_train_step(mesh, cfg, attention_sp="zigzag")
    with pytest.raises(ValueError, match="cannot shard sequence length"):
        step_zz(params, optimizer.init(params), tokens, targets)


def test_make_zigzag_attention_global_api(rng):
    """The global-array zigzag wrapper (permutation handled internally) is
    a drop-in for make_ring_attention(causal=True), fwd and grads."""
    from quantizedattention_tpu.parallel import make_zigzag_attention
    from quantizedattention_tpu.reference import reference_attention_vjp

    mesh = make_attention_mesh(data=1, model=2, context=4)
    q, k, v, do = make_qkv(rng, batch=1, head=2, q_tokens=512)
    fn = make_zigzag_attention(mesh)
    o = fn(q, k, v)
    want = reference_attention(q, k, v, causal=True)
    rep_o = mismatch_report("zigzag global api", o, want, atol=1e-2)
    assert rep_o.mismatch_rate <= 2e-3, rep_o

    dq, dk, dv = jax.grad(
        lambda *a: jnp.sum(fn(*a) * do), argnums=(0, 1, 2))(q, k, v)
    dq_w, dk_w, dv_w = reference_attention_vjp(q, k, v, do, causal=True)
    for nm, g, w in [("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)]:
        rep_g = mismatch_report(f"zz api {nm}", g, w, atol=2e-2)
        assert rep_g.mismatch_rate <= 2e-3, rep_g
