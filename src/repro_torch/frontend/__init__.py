"""FEx front end: IIR filter-bank design and the streaming feature extractor."""
