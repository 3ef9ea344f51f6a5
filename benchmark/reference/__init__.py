"""The plain float32 references of the benchmark's configurations, one module
per model, each ``forward(params, *frames) -> output frames``: ``frames`` are
a sample's inputs, as many as the configuration's call takes (``benchmark/
calls``), each (B, 3, H, W).  They import nothing of the program under test."""
