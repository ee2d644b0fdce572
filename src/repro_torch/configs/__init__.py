"""Architecture configs the port runs (the paper's LSTM in this slice)."""
