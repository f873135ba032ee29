"""The experiment framework: the flag registry and the run-dir protocol."""
