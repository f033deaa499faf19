"""The benchmark's shared machinery: finding a cell's files by name,
running its window, reading the profiler's trace and comparing with the
plain reference. Nothing here imports the port; the cell's model builder
and driver do."""
