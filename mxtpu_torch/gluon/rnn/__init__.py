"""Gluon recurrent layers and cells (the counterpart of
``mxtpu/gluon/rnn``; reference ``python/mxnet/gluon/rnn/``†)."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell,
                       LSTMCell, GRUCell, SequentialRNNCell, DropoutCell,
                       ResidualCell, BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell", "RNN", "LSTM", "GRU"]
