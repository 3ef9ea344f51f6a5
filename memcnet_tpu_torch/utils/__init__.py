"""Config and tracing (ports of memcnet_tpu/utils/config.py and tracing.py)."""
