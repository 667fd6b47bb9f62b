"""The benchmark's plain reference: float32 PyTorch, no kernel of the program.

A frozen copy of the GAN's mathematics (models, ops, ADA, the training step, approxmatch
EMD, furthest-point sampling, COV / MMD / 1-NNA), written in plain torch operations so that
it runs on the card and on the CPU alike. It imports nothing of the program under test and
takes nothing the program has made: the benchmark hands it the same seeded weights, inputs
and draws, and it works out again everything derived from them (Fourier-PE volumes,
resampling operators, ADA's matrices). `precision.py` rounds the operands of every matrix
product, convolution and resampling to a lower precision for the control runs.
"""
