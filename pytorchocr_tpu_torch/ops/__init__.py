"""Device ops of the port: the run-max kernel wrapper, CC labelling, CTC collapse."""
