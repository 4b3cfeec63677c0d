"""Traffic kinds: the code that drives one kind of traffic mix."""
