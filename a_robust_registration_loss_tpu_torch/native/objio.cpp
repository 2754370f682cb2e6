// Fast OBJ point-cloud IO: the native layer of data/objio.py.
//
// The port's own copy of the JAX package's objio.cpp. The format surface is
// what the reference pipeline uses: "v x y z" vertices and "f a b c"
// triangle faces (with optional /vt/vn suffixes); everything else is
// skipped. data/objio.py's pure-Python path is the semantics oracle.
//
// Build: g++ -O2 -shared -fPIC, done on first use by objio_native.py into
// build/torch_native/ under the repository root.

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Reads path; on success returns 0 and sets *verts (malloc'd, 3*n_verts
// floats), *faces (malloc'd, 3*n_faces int32, 0-based). Caller frees with
// objio_free. Returns nonzero on IO/parse failure.
int objio_read(const char* path, float** verts, long* n_verts, int** faces,
               long* n_faces) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(size + 1);
  if (!buf) {
    fclose(f);
    return 2;
  }
  if (fread(buf, 1, size, f) != (size_t)size) {
    free(buf);
    fclose(f);
    return 3;
  }
  fclose(f);
  buf[size] = '\0';

  // first pass: count lines starting with "v " / "f " for exact allocation
  long nv = 0, nf = 0;
  for (char* p = buf; p < buf + size;) {
    if (p[0] == 'v' && p[1] == ' ') nv++;
    else if (p[0] == 'f' && p[1] == ' ') nf++;
    while (p < buf + size && *p != '\n') p++;
    p++;
  }
  float* v = (float*)malloc(sizeof(float) * 3 * (nv ? nv : 1));
  int* fc = (int*)malloc(sizeof(int) * 3 * (nf ? nf : 1));
  if (!v || !fc) {
    free(buf);
    free(v);
    free(fc);
    return 2;
  }

  long iv = 0, jf = 0;
  int bad = 0;
  for (char* p = buf; p < buf + size;) {
    if (p[0] == 'v' && p[1] == ' ') {
      char* q = p + 2;
      for (int c = 0; c < 3; c++) {
        v[3 * iv + c] = strtof(q, &q);
      }
      iv++;
    } else if (p[0] == 'f' && p[1] == ' ') {
      char* q = p + 2;
      for (int c = 0; c < 3; c++) {
        long idx = strtol(q, &q, 10);
        if (idx == 0) { bad = 1; break; }
        fc[3 * jf + c] = (int)(idx - 1);
        // skip /vt/vn suffixes up to whitespace
        while (*q && *q != ' ' && *q != '\n' && *q != '\r') q++;
      }
      if (bad) break;
      jf++;
    }
    while (p < buf + size && *p != '\n') p++;
    p++;
  }
  free(buf);
  if (bad) {
    free(v);
    free(fc);
    return 4;
  }
  *verts = v;
  *n_verts = iv;
  *faces = fc;
  *n_faces = jf;
  return 0;
}

int objio_write(const char* path, const float* verts, long n_verts,
                const int* faces, long n_faces) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  // buffered formatting: ~48 bytes per vertex line
  const size_t cap = 1 << 16;
  char* buf = (char*)malloc(cap + 128);
  if (!buf) {
    fclose(f);
    return 2;
  }
  size_t used = 0;
  for (long i = 0; i < n_verts; i++) {
    used += (size_t)snprintf(buf + used, 128, "v %.8g %.8g %.8g\n",
                             (double)verts[3 * i], (double)verts[3 * i + 1],
                             (double)verts[3 * i + 2]);
    if (used >= cap) {
      fwrite(buf, 1, used, f);
      used = 0;
    }
  }
  for (long i = 0; i < n_faces; i++) {
    used += (size_t)snprintf(buf + used, 128, "f %d %d %d\n",
                             faces[3 * i] + 1, faces[3 * i + 1] + 1,
                             faces[3 * i + 2] + 1);
    if (used >= cap) {
      fwrite(buf, 1, used, f);
      used = 0;
    }
  }
  if (used) fwrite(buf, 1, used, f);
  free(buf);
  fclose(f);
  return 0;
}

void objio_free(void* p) { free(p); }

}  // extern "C"
