"""Planning and execution of reconstructions."""
