"""Plain PyTorch references of the configurations: Tacotron (free-running
inference and attention-forcing training) and the WaveRNN vocoder. They
import nothing of the program and read the weights the benchmark made,
by the reference state dict's names."""
