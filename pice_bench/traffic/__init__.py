"""Traffic mixes (`<mix>.json`) and the one generator that reads them."""
