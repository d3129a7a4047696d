"""Traffic kinds: the general runners a mix names by its `kind`."""
