"""One general driver per kind of traffic; a mix's ``driver`` key names
its module here, and the rest of the mix is that driver's parameters."""
