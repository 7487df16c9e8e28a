"""Sharding rules, the H100 roofline and the step cost counter."""
