"""forge_tpu_torch — the PyTorch/CUDA port of forge_tpu for NVIDIA Hopper.

A second package beside the JAX reference `forge_tpu`, with the same layers:

  ops/       primitive ops, attention front end, hand-written CUDA kernels
             (csrc/*.cu, built by ops/_build.py), host Philox RNG
  core/      checkpoint reading, architecture guess, loader, layout conversion
  models/    SD1.5 UNet, VAE decoder, CLIP-L text encoder
  text/      pure-Python CLIP BPE tokenizer, emphasis, chunking, text engine
  sampling/  σ-schedules, discrete prediction, CFG, Euler samplers
  pipeline/  engine + txt2img processing

It imports torch and numpy and never jax: the machine with the card has no
JAX, and forge_tpu imports jax on package import, so the host-only modules
the port needs are copied here, each with a header naming its source.
"""

__version__ = "0.1.0"
