"""Plain PyTorch references of the benchmark's training steps; they
import nothing of the program."""
