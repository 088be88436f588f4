"""The session cell's robot process."""
