"""NN core of the torch package: configuration, layers, networks."""
