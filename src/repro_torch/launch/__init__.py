"""Launchers of the port: the continuous-batching server (``serve``) and
the training driver (``train``)."""
