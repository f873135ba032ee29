"""Data config for pre-generated moving-MNIST pickles (the port of
sqair_tpu/configs/seq_mnist_data.py: the same flags, the same pickle
format)."""
from ..data.mnist_tools import load  # noqa: F401  (config contract)
from ..experiment import flags

flags.DEFINE_string("train_path", "seq_mnist_train.pickle", "")
flags.DEFINE_string("valid_path", "seq_mnist_validation.pickle", "")
