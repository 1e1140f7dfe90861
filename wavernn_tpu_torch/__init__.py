"""PyTorch/CUDA port of wavernn_tpu: Tacotron + WaveRNN text -> wav with
hand-written CUDA kernels for the sample loop and the decode loop.

Importing the package needs only PyTorch (CPU builds included); the
kernels build with nvcc at their first CUDA use.
"""
