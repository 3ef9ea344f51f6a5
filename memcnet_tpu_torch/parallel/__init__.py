"""Host-side work distribution (ports of memcnet_tpu/parallel).  Only the GOP
scheduler is ported; data parallel, ZeRO-1, halo tiling and multihost launch
are still to port (ROADMAP.md Queue A)."""
