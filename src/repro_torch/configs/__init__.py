"""One module per ported architecture, each defining ``CONFIG``."""
