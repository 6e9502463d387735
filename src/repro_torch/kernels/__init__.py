"""Hopper kernels of the port and their plain PyTorch versions.

``gossip_mix.gossip_mix`` and ``panel_reduce.panel_mean_consensus`` are the
wrappers the panel engine calls; ``ref`` holds the plain versions;
``build`` compiles the CUDA sources under ``csrc/`` at first use.
"""
from repro_torch.kernels import gossip_mix as _gossip_mix
from repro_torch.kernels import panel_reduce as _panel_reduce

# every kernel of the port: name -> its wrapper (each carries ``launches``)
KERNELS = {"gossip_mix": _gossip_mix.gossip_mix,
           "panel_mean_consensus": _panel_reduce.panel_mean_consensus}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}
