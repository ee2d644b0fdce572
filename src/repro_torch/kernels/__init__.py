"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the device dispatch between the two (``ops``)."""
