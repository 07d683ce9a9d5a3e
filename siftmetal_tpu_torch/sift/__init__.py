"""SIFT stages of the port: pyramid, detection, description, facade."""
