"""The NVIDIA H100 SXM's published rates, the one place the port keeps them
(``launch/dryrun.py``'s roofline and ``chip_smoke.py``'s bounds read them).

Each figure is the data sheet's dense (no sparsity) number at the card's
700 W limit; a card set to a lower power limit runs slower under load.
"""

# HBM3 bandwidth, bytes/s (NVIDIA H100 Tensor Core GPU data sheet, H100
# SXM: 3.35 TB/s)
HBM_BYTES_PER_S = 3.35e12
# float32 on the CUDA cores, FLOP/s (data sheet, H100 SXM FP32: 67
# TFLOPS). The port runs its float32 matmuls so: it turns TF32 off
# (``repro_torch/__init__.py``)
FP32_FLOPS = 67e12
# TF32 on the tensor cores, dense, FLOP/s (data sheet, H100 SXM TF32 Tensor
# Core: 989 TFLOPS with sparsity, half of it dense); the flash attention
# kernels' split-TF32 route runs three TF32 products for each float32 one
# (their 16-bit inputs, exact in TF32, one or two: chip_smoke.py's
# flash16_times counts them)
TF32_FLOPS = 495e12
SPLIT_TF32_FLOPS = TF32_FLOPS / 3
# bfloat16 on the tensor cores, dense, FLOP/s (data sheet, H100 SXM BF16
# Tensor Core: 1,979 TFLOPS with sparsity, half of it dense; FP16 the
# same): the serve route's bfloat16 matmuls (launch/dryrun.py's serve
# records) and the 16-bit flash kernels' bound (chip_smoke.py)
BF16_FLOPS = 989e12
# NVLink 4 between the cards of one node, bytes/s a direction (data sheet:
# 900 GB/s of NVLink bandwidth a card, both directions together)
NVLINK_BYTES_PER_S = 450e9
# between nodes, bytes/s a card: one 400 Gb/s NDR InfiniBand port a card (the
# DGX H100's ConnectX-7 layout: eight ports for eight cards)
INTER_NODE_BYTES_PER_S = 50e9
# cards of one node joined by NVLink (a DGX / HGX H100 board)
CARDS_PER_NODE = 8
# device memory a rank holds beyond the peak of its tensors
# (max_memory_allocated), bytes: its CUDA context with the loaded modules,
# which the caching allocator does not see, and the allocator's reserve
# over that peak. Measured by chip_smoke.py phase 12e on phase 12b's 4
# ranks (H100 80GB HBM3 at 700 W; expandable segments): a context of
# 783,908,864 B and a reserve of 994,576,384 B over the peak, 1,778,485,248
# B a rank, rounded up to 128 MiB. The reserve is that workload's; another
# allocates in another pattern
RANK_RESERVE_BYTES = 1_879_048_192
# device memory of the H100 80GB HBM3 as the CUDA runtime reports it,
# bytes (torch.cuda.get_device_properties(0).total_memory; chip_smoke.py
# prints it and checks this figure)
MEMORY_BYTES = 85_017_493_504
