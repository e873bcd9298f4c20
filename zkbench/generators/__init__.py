"""Traffic generators: the general code that sets up, runs and checks one kind
of traffic. A mix's ``generator`` key names its module here."""
