"""mc_span_ms.stream's reading (its file says what it reads), in the float32 stream
cell, whose end-to-end metric is frames_per_s.f32."""

from benchmark.run import reader

read = reader("mc_span_ms.stream")
