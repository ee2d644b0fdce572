"""Models of the port: the paper's LSTM and the dense transformer family
(``layers``, ``blocks``, ``model``)."""
