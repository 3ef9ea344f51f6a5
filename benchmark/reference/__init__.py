"""The plain float32 references of the benchmark's configurations, one module
per model, each ``forward(params, x0, x2) -> rectified frames``.  They import
nothing of the program under test."""
