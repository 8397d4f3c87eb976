"""Synthetic keyword audio (SynthCommands) for serving requests."""
