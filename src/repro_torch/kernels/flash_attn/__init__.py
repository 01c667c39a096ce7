"""Attention kernels: paged decode (``decode``) and prefill flash
attention (``ops.flash_attention``), each beside its plain version."""
