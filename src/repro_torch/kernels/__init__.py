"""Hopper kernels of the port and their plain PyTorch versions.

``gossip_mix.gossip_mix`` and ``panel_reduce.panel_mean_consensus``
(float32, bfloat16 and float16 panels) are the wrappers the panel engine
calls; ``wire_quant`` holds the wire codecs' kernels (int8 quantize, with
supplied uniforms or with Philox draws on the chip, and dequantize, the
top-k sparsifier, int4 quantize, dequantize, nibble pack
and unpack) and the residency storages' grouped int8 quantize and
dequantize; ``merge_ops`` the merge operators' column reductions (the
weighted and the TIES column merge); ``opt_fused`` the fused AdamW step on
grouped-int8 moments; ``flash_attention`` the blockwise attention
route's forward and backward kernels (float32, bfloat16 and float16
libraries); ``ref`` holds the plain versions;
``build`` compiles the CUDA sources under ``csrc/`` at first use.
"""
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import gossip_mix as _gossip_mix
from repro_torch.kernels import merge_ops as _merge_ops
from repro_torch.kernels import opt_fused as _opt_fused
from repro_torch.kernels import panel_reduce as _panel_reduce
from repro_torch.kernels import wire_quant as _wire_quant

# every kernel of the port: name -> its wrapper (each carries ``launches``)
KERNELS = {"gossip_mix": _gossip_mix.gossip_mix,
           "panel_mean_consensus": _panel_reduce.panel_mean_consensus,
           "quantize_int8": _wire_quant.quantize_int8,
           "quantize_int8_native": _wire_quant.quantize_int8_native,
           "dequantize_int8": _wire_quant.dequantize_int8,
           "sparsify_topk": _wire_quant.sparsify_topk,
           "quantize_int4": _wire_quant.quantize_int4,
           "dequantize_int4": _wire_quant.dequantize_int4,
           "pack_int4": _wire_quant.pack_int4,
           "unpack_int4": _wire_quant.unpack_int4,
           "weighted_colmerge": _merge_ops.weighted_colmerge,
           "ties_colmerge": _merge_ops.ties_colmerge,
           "quantize_int8_grouped": _wire_quant.quantize_int8_grouped,
           "dequantize_int8_grouped": _wire_quant.dequantize_int8_grouped,
           "adamw_fused_int8": _opt_fused.adamw_fused_int8,
           "flash_attention_fwd": _flash_attention.flash_attention_fwd,
           "flash_attention_bwd": _flash_attention.flash_attention_bwd}

# the CUDA sources (csrc/<name>.cu) the kernels are built from
SOURCES = ("gossip_mix", "panel_reduce", "wire_quant", "wire_native",
           "wire_int4", "merge_ops", "wire_int8g", "opt_fused",
           "flash_attention", "flash_attention_bf16", "flash_attention_f16")
# kernels whose 16-bit entries keep counts of their own (launches_bf16,
# launches_f16; their ``launches`` counts every type)
_NARROW = (_gossip_mix.gossip_mix, _panel_reduce.panel_mean_consensus,
           _flash_attention.flash_attention_fwd,
           _flash_attention.flash_attention_bwd)


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in _NARROW:
        fn.launches_bf16 = fn.launches_f16 = 0


def launch_counts():
    """{kernel: launches}, with ``<kernel>_bf16`` / ``<kernel>_f16`` the
    bf16 / f16 variants' share of ``<kernel>`` for ``gossip_mix``,
    ``panel_mean_consensus``, ``flash_attention_fwd`` and
    ``flash_attention_bwd``."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for name, fn in KERNELS.items():
        if fn in _NARROW:
            counts[f"{name}_bf16"] = fn.launches_bf16
            counts[f"{name}_f16"] = fn.launches_f16
    return counts
