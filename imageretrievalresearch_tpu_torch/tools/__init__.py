"""Measurement tools that run on the card (``profile_fused_kernel``,
``image_kernel_times``)."""
