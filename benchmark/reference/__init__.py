"""The plain reference and the comparison that decides ``correct``.

Nothing here imports the port or JAX: ``plain.py`` works out again, from
the inputs the benchmark generated, what the served path must deliver
for a sample of devices; ``compare.py`` holds the program's outputs
against it.
"""
