"""One decode step's attention over a paged K/V view."""
