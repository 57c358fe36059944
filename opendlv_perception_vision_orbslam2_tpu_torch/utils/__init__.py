"""Config, numpy synthetic fixtures, trajectory metrics, state conversion."""
