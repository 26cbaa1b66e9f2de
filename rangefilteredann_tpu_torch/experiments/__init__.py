"""The experiment layer of the port: protocol datasets, the benchmark
driver, the analyses and the baseline runners.

Counterpart of rangefilteredann_tpu/experiments/, module for module. Both
packages read and write the same `.npy` protocol files, the same
`index_cache/` graph files and the same results CSV schema, so a dataset or
a graph made by one loads into the other. Ground truth and searches run on
the card unless the caller passes `device="cpu"` (`--device cpu` on the
command line).
"""
