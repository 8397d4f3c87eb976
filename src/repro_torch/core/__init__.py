"""Core ΔGRU, fixed-point quantization and the IC energy model."""
