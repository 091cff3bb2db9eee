"""Hand-written GPU kernels for the hot CAVI inner loops.

Each replaces a set of the reference's embedded OpenCL kernels
(gpuLDA.jl string constants) and stays only while it beats the plain
XLA body end to end on the card (PERF.md).  ``lda_estep`` is a Pallas
kernel lowered through Triton; its tests run it in interpret mode.
"""
