"""Model zoo: conf builders for the architectures the package runs."""
