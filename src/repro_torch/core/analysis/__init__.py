"""Device analysis engines (`wavefront`) over torch tensors."""
