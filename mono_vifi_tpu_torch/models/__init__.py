"""Networks of the port, NCHW, reference PyTorch state_dict keys."""
