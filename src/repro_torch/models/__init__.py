"""The 10 assigned LM architectures in eager PyTorch: plain functions
over tensors and nested parameter dicts, one Python loop over the
repeating layer unit."""
