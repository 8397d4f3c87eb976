"""Model configurations (the DeltaKWS model)."""
