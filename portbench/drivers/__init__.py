"""One module a traffic driver, found by the name a mix gives."""
