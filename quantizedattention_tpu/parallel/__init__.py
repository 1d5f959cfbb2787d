"""Multi-chip distribution layer (shard_map over a jax.sharding.Mesh).

This whole layer is new capability relative to the reference, which is
single-GPU only (SURVEY.md §2.4: zero torch.distributed / NCCL usage; its
only scaling mechanism is the O(seq) online-softmax stream inside one
device). This build scales the same kernels across the cards of a mesh:

  * head-sharded tensor parallelism (the attention grid already iterates
    b·h independently, so head sharding is communication-free);
  * ring attention for sequence scaling — KV shards (and,
    for int8, their quantized blocks + scale tables) rotate via
    jax.lax.ppermute while each chip streams its partial online softmax,
    merged with the kernels' own (m, l) rescale identity;
  * an int8-quantized KV cache with GQA decode for serving.
"""

from quantizedattention_tpu.parallel.mesh import make_attention_mesh
from quantizedattention_tpu.parallel.multihost import initialize_multihost, make_pod_mesh
from quantizedattention_tpu.parallel.sharded import make_sharded_attention
from quantizedattention_tpu.parallel.ring import ring_attention, make_ring_attention, ring_attention_jvp
from quantizedattention_tpu.parallel.ulysses import ulysses_attention, make_ulysses_attention
from quantizedattention_tpu.parallel.zigzag import (
    zigzag_local_positions,
    zigzag_perm,
    zigzag_ring_attention,
    zigzag_ring_attention_int8,
    make_zigzag_attention,
)
from quantizedattention_tpu.parallel.collective import (
    allgather_kv_attention,
    allgather_kv_attention_int8,
    kv_sharded_attention_int8,
    kv_sharded_attention,
    make_allgather_attention,
)
from quantizedattention_tpu.parallel.paged_cache import (
    PagedKVCache,
    init_paged_cache,
    assign_pages,
    write_prompt_paged,
    append_token_paged,
    paged_decode_attention,
)
from quantizedattention_tpu.parallel.kv4_cache import (
    Int4KVCache,
    append_kv4,
    decode_attention_int4,
    dequantize_kv4,
    init_kv4_cache,
    verify_decode_attention_int4,
    write_kv4_slot,
)
from quantizedattention_tpu.parallel.kv_cache import (
    QuantizedKVCache,
    init_kv_cache,
    append_kv,
    write_kv_slot,
    decode_attention,
    verify_decode_attention,
    context_sharded_decode,
    shard_cache_context,
)

__all__ = [
    "zigzag_ring_attention",
    "make_zigzag_attention",
    "zigzag_ring_attention_int8",
    "zigzag_perm",
    "zigzag_local_positions",
    "make_attention_mesh",
    "initialize_multihost",
    "make_pod_mesh",
    "make_sharded_attention",
    "ring_attention",
    "make_ring_attention",
    "ring_attention_jvp",
    "ulysses_attention",
    "make_ulysses_attention",
    "allgather_kv_attention",
    "allgather_kv_attention_int8",
    "kv_sharded_attention_int8",
    "kv_sharded_attention",
    "make_allgather_attention",
    "QuantizedKVCache",
    "init_kv_cache",
    "append_kv",
    "write_kv_slot",
    "decode_attention",
    "Int4KVCache",
    "append_kv4",
    "decode_attention_int4",
    "dequantize_kv4",
    "init_kv4_cache",
    "verify_decode_attention_int4",
    "write_kv4_slot",
    "verify_decode_attention",
    "context_sharded_decode",
    "shard_cache_context",
    "PagedKVCache",
    "init_paged_cache",
    "assign_pages",
    "write_prompt_paged",
    "append_token_paged",
    "paged_decode_attention",
]
