"""Step functions and the serving loop of the LM path."""
