"""Models of the port: DLRM (single device), its data, and parameter
conversion from the reference package's layout."""
