"""Host-side native code of the port: the C++ ring loader (`loader.cpp`)."""
