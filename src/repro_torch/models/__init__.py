"""Models of the port (the paper LSTM in this slice)."""
