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
route's forward and backward kernels; ``ref`` holds the plain versions;
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
           "flash_attention")


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    _gossip_mix.gossip_mix.launches_bf16 = 0
    _gossip_mix.gossip_mix.launches_f16 = 0
    _panel_reduce.panel_mean_consensus.launches_bf16 = 0
    _panel_reduce.panel_mean_consensus.launches_f16 = 0


def launch_counts():
    """{kernel: launches}, with ``gossip_mix_bf16`` / ``gossip_mix_f16``
    the bf16 / f16 variants' share of ``gossip_mix`` and
    ``panel_mean_consensus_bf16`` / ``panel_mean_consensus_f16`` theirs of
    ``panel_mean_consensus``."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["gossip_mix_bf16"] = _gossip_mix.gossip_mix.launches_bf16
    counts["gossip_mix_f16"] = _gossip_mix.gossip_mix.launches_f16
    counts["panel_mean_consensus_bf16"] = (
        _panel_reduce.panel_mean_consensus.launches_bf16)
    counts["panel_mean_consensus_f16"] = (
        _panel_reduce.panel_mean_consensus.launches_f16)
    return counts
