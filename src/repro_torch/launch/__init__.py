"""Launchers (port of ``repro/launch``): ``serve`` drives the LM engine
from the command line, ``train`` the training loop."""
