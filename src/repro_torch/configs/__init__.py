"""Configurations: the paper's FL experiment setup (``colrel_paper``,
``channels``) and the model zoo's architectures (``base`` and one module
per ported arch)."""
