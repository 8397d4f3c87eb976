"""The keyword-spotting model: inference and weight conversion."""
