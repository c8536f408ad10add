"""Extensions on the UNet's and the CFG's hook layers (port of
forge_tpu/extensions/): FreeU, PAG, SAG, dynamic thresholding, latent
modifier, hypernetworks, StyleAlign and ControlLLLite. Each fills
`Processing.unet_hooks` or the CFG hook fields through its `attach` or
`build_*` function; the hooks see NCHW tensors."""
